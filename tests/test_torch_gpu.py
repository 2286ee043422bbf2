"""The CUDA kernels (flash attention and its backward, grouped matmul and its
backward, Mamba selective scan and its backward, RG-LRU scan and its
backward, embedding bag and its backward) against their plain versions, the
narrow models (and a narrow DLRM) on the card against the CPU, narrow train
steps (dense, MoE, Mamba, hybrid and DLRM) on the card
against the same on the CPU, the planner's
device path (pricing and chains) against its NumPy oracles, and the online
controller's fused admission on the card against the same on the CPU.

Run on a machine with a CUDA card: ``python -m pytest -m gpu tests/test_torch_gpu.py``.
Every test here skips without one (decided in the fixture, never at import).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, torch_dtype
from repro_torch.kernels import embedding_bag as bag_mod
from repro_torch.kernels import flash_attention as attn_mod
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import (
    BWD_TILINGS, N_SMALL, bag_bwd_tiling, bag_fwd_split, embedding_bag, embedding_bag_bwd,
    key_dtype, sorted_keys,
)
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn, first_masked_row, flash_attention, flash_attention_bwd,
)
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
from repro_torch.kernels.moe_gmm import BWD_TILINGS as GMM_BWD_TILINGS
from repro_torch.kernels import moe_gmm as gmm_mod
from repro_torch.kernels.moe_gmm import gmm_bwd_tiling, moe_gmm, moe_gmm_bwd
from repro_torch.kernels.ref import (
    ref_embedding_bag, ref_embedding_bag_bwd, ref_embedding_bag_in_order, ref_flash_attention,
    ref_flash_attention_lse, ref_mamba_scan, ref_mamba_scan_bwd, ref_moe_gmm, ref_moe_gmm_bwd,
    ref_rglru_scan, ref_rglru_scan_bwd,
)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
from repro_torch import optim
from repro_torch.core import planeval_torch as pt
from repro_torch.core import workloads as wl
from repro_torch.core.netsim import HardwareSpec
from repro_torch.core.planeval import plan_evaluator
from repro_torch.core.strategy_search import default_strategy
from repro_torch.core.topology_finder import remove_pair, topology_finder
from repro_torch.models import dlrm, layers, lm
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
    q264, k264, v264 = _qkv(cuda, 1, 4, 2, 64, 64, 264, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 264"):
        ops.attention(q264, k264, v264)
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
# The grouped matmul's backward, and MoE training
# ---------------------------------------------------------------------------


def _xwdy(device, E, C, D, F, dtype, seed=0):
    x, w = _xw(device, E, C, D, F, dtype, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return x, w, torch.randn(E, C, F, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize(
    "E,C,D,F,dtype,tiling",
    [
        # qwen3-moe-30b-a3b's training products (C = 1280): gate/up and down.
        (128, 1280, 2048, 768, torch.bfloat16, "wgmma"),
        (128, 1280, 768, 2048, torch.bfloat16, "wgmma"),
        (128, 1280, 2048, 768, torch.float16, "wgmma"),
        (16, 1280, 2048, 768, torch.float32, "fma"),
        # Ragged around the 128 x 256 tiles, a decode-sized batch, and D, F
        # off TMA's strides.
        (4, 129, 72, 136, torch.bfloat16, "wgmma"),
        (4, 129, 72, 136, torch.float16, "wgmma"),
        (4, 129, 72, 136, torch.bfloat16, "fma"),
        (4, 129, 72, 136, torch.float32, "fma"),
        (8, 1, 2048, 768, torch.bfloat16, "wgmma"),
        (3, 77, 201, 135, torch.bfloat16, "fma"),
        (3, 77, 201, 135, torch.float32, "fma"),
    ],
)
def test_gmm_bwd_kernel_matches_plain(cuda, E, C, D, F, dtype, tiling):
    """dx and dw against ``ref_moe_gmm_bwd`` at the forward's bar in each
    dtype; each output alone equal to the bit to the pair."""
    x, w, dy = _xwdy(cuda, E, C, D, F, dtype)
    dx, dw = moe_gmm_bwd(x, w, dy, tiling=tiling)
    torch.cuda.synchronize()
    rx, rw = ref_moe_gmm_bwd(x, w, dy)
    assert dx.dtype == dw.dtype == dtype and dx.shape == x.shape and dw.shape == w.shape
    torch.testing.assert_close(dx.float(), rx.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(dw.float(), rw.float(), rtol=TOL[dtype], atol=TOL[dtype])
    only_dx = moe_gmm_bwd(x, w, dy, need_dw=False, tiling=tiling)
    only_dw = moe_gmm_bwd(x, w, dy, need_dx=False, tiling=tiling)
    assert only_dx[1] is None and only_dw[0] is None
    assert torch.equal(only_dx[0], dx) and torch.equal(only_dw[1], dw)


@pytest.mark.parametrize("tiling,dtype", [("wgmma", torch.bfloat16), ("fma", torch.float32)])
def test_gmm_bwd_kernel_is_deterministic(cuda, tiling, dtype):
    """No split of the reduction and no atomics: two launches give the same
    bits."""
    x, w, dy = _xwdy(cuda, 16, 1280, 768, 2048, dtype, seed=3)
    first = moe_gmm_bwd(x, w, dy, tiling=tiling)
    second = moe_gmm_bwd(x, w, dy, tiling=tiling)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


# What only the persistent wgmma backward's walk can get wrong: fewer tiles
# than SMs (E = 1, C = 128, D = F = 256); one M tile of dx (C = 1) and of dw
# (D = 72), two (C = 129) and three (C = 300: an odd count in pairs, whose
# second block computes zeros and stores nothing); tile counts no multiple of
# the SMs; the ragged shape in both half types.  The launch is sized by the
# SM count the wrapper passes (patched here): this card's; 1 << 20, one unit
# of work a cluster (not persistent); and cards of 2, 3, 5 and 7 SMs, each
# block (or pair) walking many tiles.  Every launch gives the default's bits.
GMM_BWD_WALKS = [(1, 128, 256, 256, torch.bfloat16), (4, 129, 72, 136, torch.bfloat16),
                 (4, 129, 72, 136, torch.float16), (3, 129, 136, 72, torch.bfloat16),
                 (8, 1, 2048, 768, torch.bfloat16), (7, 300, 520, 264, torch.bfloat16),
                 (16, 1280, 768, 2048, torch.bfloat16)]
GMM_BWD_LAUNCHES = [None, 1 << 20, 2, 3, 5, 7]


@pytest.mark.parametrize("E,C,D,F,dtype", GMM_BWD_WALKS)
@pytest.mark.parametrize("launch", GMM_BWD_LAUNCHES)
def test_gmm_bwd_walks_match_plain(cuda, monkeypatch, E, C, D, F, dtype, launch):
    x, w, dy = _xwdy(cuda, E, C, D, F, dtype, seed=5)
    default = moe_gmm_bwd(x, w, dy)
    if launch is not None:
        monkeypatch.setattr(gmm_mod, "sm_count", lambda index: launch)
    dx, dw = moe_gmm_bwd(x, w, dy, tiling="wgmma")
    torch.cuda.synchronize()
    rx, rw = ref_moe_gmm_bwd(x, w, dy)
    torch.testing.assert_close(dx.float(), rx.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(dw.float(), rw.float(), rtol=TOL[dtype], atol=TOL[dtype])
    again = moe_gmm_bwd(x, w, dy, tiling="wgmma")
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    assert torch.equal(default[0], dx) and torch.equal(default[1], dw)


@pytest.mark.parametrize("sms", [1, 3, 7, 64])
@pytest.mark.parametrize("E,C,D,F", [(16, 1280, 768, 2048), (7, 300, 520, 264), (4, 129, 72, 136)])
def test_gmm_bwd_walks_on_fewer_blocks(cuda, monkeypatch, sms, E, C, D, F):
    """Fewer persistent blocks than SMs (the wrapper's SM count patched):
    each block walks many tiles, a count no multiple of its blocks, with the
    ring running on across them; the same bits as on the whole card."""
    x, w, dy = _xwdy(cuda, E, C, D, F, torch.bfloat16, seed=6)
    want = moe_gmm_bwd(x, w, dy)
    monkeypatch.setattr(gmm_mod, "sm_count", lambda index: sms)
    got = moe_gmm_bwd(x, w, dy)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rx, rw = ref_moe_gmm_bwd(x, w, dy)
    torch.testing.assert_close(got[0].float(), rx.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got[1].float(), rw.float(), rtol=2e-2, atol=2e-2)


def test_gmm_bwd_kernel_takes_strided_views(cuda):
    x, w, dy = _xwdy(cuda, 4, 40, 256, 384, torch.bfloat16)
    dyt = dy.transpose(1, 2).contiguous().transpose(1, 2)
    assert not dyt.is_contiguous()
    got, want = moe_gmm_bwd(x, w, dyt), moe_gmm_bwd(x, w, dy)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_gmm_bwd_wrapper_refuses_what_it_does_not_take(cuda):
    x, w, dy = _xwdy(cuda, 2, 40, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm_bwd(x.cpu(), w.cpu(), dy.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm_bwd(x, w, dy.cpu())
    with pytest.raises(ValueError, match="share"):
        moe_gmm_bwd(x, w.float(), dy)
    with pytest.raises(ValueError, match="share"):
        moe_gmm_bwd(x, w, dy.half())
    with pytest.raises(ValueError, match="dy"):
        moe_gmm_bwd(x, w, dy[:, :, :16])
    with pytest.raises(ValueError, match="tiling"):
        moe_gmm_bwd(x.float(), w.float(), dy.float(), tiling="wgmma")
    xb, wb, dyb = _xwdy(cuda, 2, 40, 60, 32, torch.bfloat16)  # D % 8 != 0: no TMA stride
    with pytest.raises(ValueError, match="tiling"):
        moe_gmm_bwd(xb, wb, dyb, tiling="wgmma")
    with pytest.raises(ValueError, match="tiling"):
        moe_gmm_bwd(x, w, dy, tiling="skinny")
    assert gmm_bwd_tiling(torch.bfloat16, 40, 60, 32) == "fma"
    assert set(GMM_BWD_TILINGS) == {"wgmma", "fma"}


GMM_BWD_COUNTERS = ("grouped_matmul_launches", "grouped_matmul_wgmma_launches",
                    "grouped_matmul_fma_launches", "grouped_matmul_skinny_launches",
                    "grouped_matmul_bwd_launches", "grouped_matmul_bwd_wgmma_launches",
                    "grouped_matmul_bwd_fma_launches")


@pytest.mark.parametrize("C,dtype,fwd,bwd", [(312, torch.bfloat16, "wgmma", "wgmma"),
                                              (1, torch.bfloat16, "skinny", "wgmma"),
                                              (40, torch.float32, "fma", "fma")])
def test_grouped_matmul_under_grad_counts_one_backward_a_product(cuda, monkeypatch, C, dtype,
                                                                  fwd, bwd):
    """Under grad, ``ops.grouped_matmul`` goes through GroupedMatmulFn: one
    forward launch on the serving tiling, one backward call when autograd
    asks (dx and dw in it), the kernel's gradients; under no_grad no graph."""
    for name in GMM_BWD_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    x, w, dy = _xwdy(cuda, 8, C, 256, 128, dtype)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = ops.grouped_matmul(xl, wl)
    assert type(out.grad_fn).__name__ == "GroupedMatmulFnBackward"
    assert torch.equal(out, moe_gmm(x, w))
    gx, gw = torch.autograd.grad(out, (xl, wl), dy)
    counts = {n: getattr(ops, n) for n in GMM_BWD_COUNTERS}
    want = {n: 0 for n in GMM_BWD_COUNTERS}
    want.update({"grouped_matmul_launches": 1, f"grouped_matmul_{fwd}_launches": 1,
                 "grouped_matmul_bwd_launches": 1, f"grouped_matmul_bwd_{bwd}_launches": 1})
    assert counts == want
    kx, kw = moe_gmm_bwd(x, w, dy)
    assert torch.equal(gx, kx) and torch.equal(gw, kw)
    with torch.no_grad():
        assert ops.grouped_matmul(xl, wl).grad_fn is None
    assert ops.grouped_matmul_bwd_launches == 1


def test_tma_kernels_launch_from_a_thread_with_no_context(cuda):
    """A thread that has made no CUDA call has no current context, and a TMA
    tensor map cannot be encoded there until one is made current (autograd's
    worker, when the first node of a backward is the grouped matmul's, failed
    with error 1 before ``hopper.cuh`` made it so).  Each TMA kernel's first
    launch on a fresh thread gives the main thread's bits."""
    import threading

    x, w, dy = _xwdy(cuda, 8, 312, 256, 128, torch.bfloat16)
    q, k, v = _qkv(cuda, 1, 4, 2, 256, 256, 128, torch.bfloat16)
    calls = {"moe_gmm_bwd": lambda: moe_gmm_bwd(x, w, dy), "moe_gmm": lambda: (moe_gmm(x, w),),
             "flash_attention": lambda: (flash_attention(q, k, v),)}
    for name, fn in calls.items():
        got = {}
        thread = threading.Thread(target=lambda: got.update(out=fn()))
        thread.start()
        thread.join(timeout=120)
        assert not thread.is_alive(), name
        torch.cuda.synchronize()
        assert "out" in got, name  # the launch raised in the thread
        for a, b in zip(got["out"], fn()):
            assert torch.equal(a, b), name


def test_moe_backward_never_waits_on_the_card(cuda):
    """The MoE layer's forward and backward under grad enqueue their work
    without a host sync: no ``.item()``, no ``nonzero``, no boolean-mask
    indexing in the dispatch, the combine or their gradients."""
    cfg = _narrow_moe_config()
    mod = layers.MoE(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    params = list(mod.parameters())
    for p in params:
        p.requires_grad_(True)
    x = torch.randn(2, 77, cfg.d_model, device=cuda, requires_grad=True)
    out, aux = layers.moe(mod, layers.rms_norm(x, mod.norm), cfg)  # warm-up
    torch.autograd.grad((out * out).sum() + aux, [x, *params])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = layers.moe(mod, layers.rms_norm(x, mod.norm), cfg)
        grads = torch.autograd.grad((out * out).sum() + aux, [x, *params])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("capacity_factor", [2.0, 1.0])
def test_moe_train_step_on_card_matches_cpu(cuda, monkeypatch, capacity_factor):
    """One narrow fp32 MoE train step (head dim 64, 8 experts, top 2; C above
    16, entries dropped at capacity 1.0): the loss and every gradient, the
    router's included, within 1e-5 of the leaf's max of the CPU's, and the
    launches remat "full" implies (each forward twice, one backward call a
    product).  After one AdamW step (lr 1e-3, update lr * g / (|g| + eps)),
    the parameters within 1e-4 of the leaf's max where the CPU's gradient is
    above the gradients' bar and 100 eps; on the entries within rounding of
    g = 0 rounding alone moves the update, by at most 2 lr."""
    for name in GMM_BWD_COUNTERS + ("attention_launches", "attention_bwd_launches"):
        monkeypatch.setattr(ops, name, 0)
    cfg = dataclasses.replace(_narrow_moe_config(), n_layers=2, capacity_factor=capacity_factor)
    m_cpu = lm.init(0, cfg, device="cpu")
    m_gpu = lm.init(0, cfg, device=cuda)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(4))
    grads = {}
    for name, m, t in (("cpu", m_cpu, toks), ("card", m_gpu, toks.to(cuda))):
        m.requires_grad_(True)
        params = dict(m.named_parameters())
        loss, _ = lm.loss_fn(m, {"tokens": t}, cfg, loss_chunk=32)
        grads[name] = (float(loss.detach()), dict(zip(params, torch.autograd.grad(loss, list(
            params.values())))))
    L_ = cfg.n_layers
    assert (ops.grouped_matmul_launches, ops.grouped_matmul_fma_launches) == (6 * L_, 6 * L_)
    assert (ops.grouped_matmul_bwd_launches, ops.grouped_matmul_bwd_fma_launches) == (3 * L_,
                                                                                      3 * L_)
    assert (ops.attention_launches, ops.attention_bwd_launches) == (2 * L_, L_)
    (lc, gc_), (lg, gg) = grads["cpu"], grads["card"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for name, want in gc_.items():
        bar = 1e-5 * float(want.abs().max())
        assert float((gg[name].cpu() - want).abs().max()) <= bar, name
    lr = 1e-3
    for m, t in ((m_cpu, toks), (m_gpu, toks.to(cuda))):
        opt = optim.adamw(optim.constant(lr), weight_decay=0.0)
        make_train_step(cfg, opt, loss_chunk=32)(m, opt.init(dict(m.named_parameters())),
                                                 {"tokens": t}, 0)
    for (name, pg), pc in zip(m_gpu.named_parameters(), m_cpu.parameters()):
        g = gc_[name].abs()
        loose = (g <= 1e-5 * g.max()) | (g <= 1e-6)
        diff = (pg.detach().cpu() - pc.detach()).abs()
        bar = 1e-4 * float(pc.abs().max())
        assert float(torch.where(loose, 0.0, diff).max()) <= bar, name
        assert float(torch.where(loose, diff, 0.0).max()) <= 2 * lr * (1 + 1e-3), name


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
    "B,L,D", [(4, 2048, 4096), (1, 4096, 4096), (3, 1000, 200), (2, 17, 130), (1, 1, 5),
              (1, 33, 7), (2, 64, 33)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_rglru_kernel_matches_plain(cuda, B, L, D, dtype):
    """fp32 arithmetic from the same inputs in both; the kernel composes its
    chunks' carries (products of 16 decays), a few dozen ulps inside 1e-5.
    The prefill and training shapes; L off the 128-step rounds; D off the
    32-channel tiles, and rows TMA cannot stride (D x the element size off
    16 bytes: 130, 5, 7, 33 in fp32)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = (torch.rand(B, L, D, generator=gen, device=cuda) * 0.89 + 0.1).to(dtype)
    b = torch.randn(B, L, D, generator=gen, device=cuda).to(dtype)
    h, f = rglru_scan(a, b)
    torch.cuda.synchronize()
    eh, ef = ref_rglru_scan(a, b)
    assert h.dtype == f.dtype == torch.float32 and f.shape == (B, D)
    torch.testing.assert_close(h, eh, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f, ef, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L,D", [(1, 4096, 4096), (2, 1000, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_is_deterministic(cuda, B, L, D, dtype):
    """The carries are composed in a fixed order: two launches give the same
    bits (TMA staging at the training shape, plain loads at D = 33)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = (torch.rand(B, L, D, generator=gen, device=cuda) * 0.89 + 0.1).to(dtype)
    b = torch.randn(B, L, D, generator=gen, device=cuda).to(dtype)
    first, second = rglru_scan(a, b), rglru_scan(a, b)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert torch.equal(first[1], first[0][:, -1])  # h_final is h_all's last step


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


def _lru_bwd_inputs(device, B, L, D, dtype, seed=0):
    """a in the forward's range (0.1..0.99), b, the forward's h_all, and the
    cotangents of h_all and h_final (fp32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = (torch.rand(B, L, D, generator=gen, device=device) * 0.89 + 0.1).to(dtype)
    b = torch.randn(B, L, D, generator=gen, device=device).to(dtype)
    h_all = rglru_scan(a, b)[0]
    dh = torch.randn(B, L, D, generator=gen, device=device)
    dhf = torch.randn(B, D, generator=gen, device=device)
    return a, h_all, dh, dhf


@pytest.mark.parametrize(
    "B,L,D", [(1, 4096, 4096), (4, 2048, 4096), (3, 1000, 200), (2, 17, 130), (1, 1, 5),
              (2, 64, 33), (1, 33, 7)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("with_dh", [False, True])
def test_rglru_bwd_kernel_matches_plain(cuda, B, L, D, dtype, with_dh):
    """da and db against the plain reverse walk: within 1e-4 of each one's
    max|.| (the chunks' carries are products in another order), plus one
    rounding of the dtype where a is 16-bit (the gradients come back in a's
    dtype).  Recurrentgemma-9b's training shape (B = 1, L = D = 4096), L
    off the 128-step rounds and D off the 32-channel tiles among them, and
    rows TMA cannot stride (D = 130, 5, 33, 7 in fp32)."""
    a, h_all, dh, dhf = _lru_bwd_inputs(cuda, B, L, D, dtype)
    dhf = dhf if with_dh else None
    got = rglru_scan_bwd(a, h_all, dh, dhf)
    torch.cuda.synchronize()
    for name, g, w in zip(("da", "db"), got, ref_rglru_scan_bwd(a, h_all, dh, dhf)):
        assert g.dtype == w.dtype == dtype and g.shape == (B, L, D), name
        g, w = g.float(), w.float()
        bar = 1e-4 * float(w.abs().max())
        if dtype != torch.float32:
            bar = bar + torch.finfo(dtype).eps * w.abs()
        assert bool(((g - w).abs() <= bar).all()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_bwd_kernel_is_deterministic(cuda, dtype):
    """No float atomics: two launches give the same bits."""
    a, h_all, dh, dhf = _lru_bwd_inputs(cuda, 2, 1000, 520, dtype, seed=1)
    first = rglru_scan_bwd(a, h_all, dh, dhf)
    second = rglru_scan_bwd(a, h_all, dh, dhf)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_rglru_bwd_wrapper_refuses_what_it_does_not_take(cuda):
    a, h_all, dh, dhf = _lru_bwd_inputs(cuda, 1, 8, 16, torch.float32)
    with pytest.raises(ValueError, match="h_all"):
        rglru_scan_bwd(a, h_all.half(), dh)
    with pytest.raises(ValueError, match="dh_all"):
        rglru_scan_bwd(a, h_all, dh[:, :4])
    with pytest.raises(ValueError, match="dh_all"):
        rglru_scan_bwd(a, h_all, dh.double())
    with pytest.raises(ValueError, match="dh_final"):
        rglru_scan_bwd(a, h_all, dh, dhf[:, :8])
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_bwd(a, h_all, dh, dhf.cpu())
    with pytest.raises(ValueError, match="one of"):
        rglru_scan_bwd(a.double(), h_all, dh)
    with pytest.raises(ValueError, match="B,L,D"):
        rglru_scan_bwd(a[0], h_all, dh)


def test_lru_scan_under_grad_counts_one_backward(cuda, monkeypatch):
    """Under grad, ``ops.lru_scan`` goes through LruScanFn: one forward launch
    (the serving kernel's bits), one backward launch when autograd asks (da
    and db in it), the kernel's gradients; under no_grad, or with inputs
    that need no grad, no graph.  (This replaces the refusal under grad the
    scan had before its backward kernel.)"""
    for name in ("lru_scan_launches", "lru_scan_bwd_launches"):
        monkeypatch.setattr(ops, name, 0)
    a, h_all, dh, dhf = _lru_bwd_inputs(cuda, 2, 300, 256, torch.float32, seed=2)
    b = torch.randn_like(a)
    assert ops.lru_scan(a, b)[0].grad_fn is None  # no input needs grad: serving
    leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    h, f = ops.lru_scan(*leaves)
    assert type(h.grad_fn).__name__ == "LruScanFnBackward"
    assert torch.equal(h, rglru_scan(a, b)[0]) and torch.equal(f, rglru_scan(a, b)[1])
    got = torch.autograd.grad((h, f), leaves, (dh, dhf))
    assert (ops.lru_scan_launches, ops.lru_scan_bwd_launches) == (2, 1)
    want = rglru_scan_bwd(a, h.detach(), dh, dhf)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        assert ops.lru_scan(*leaves)[0].grad_fn is None
    assert (ops.lru_scan_launches, ops.lru_scan_bwd_launches) == (3, 1)


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


MAMBA_BWD_NAMES = ("dxc", "ddt", "da", "db", "dc", "dd")


def _assert_mamba_bwd_close(got, want, dtype):
    """Each fp32 output within 1e-4 of its max|.| (the forward's bar: the sums
    over channels and steps run in another order); an output in bf16 or fp16
    (dxc, db, dc) within that plus one rounding on each side, the dtype's eps
    times the value (2^-7 in bf16, 2^-10 in fp16)."""
    for name, g, w in zip(MAMBA_BWD_NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        g, w = g.float(), w.float()
        bar = 1e-4 * float(w.abs().max())
        if dtype != torch.float32 and name in ("dxc", "db", "dc"):
            bar = bar + torch.finfo(dtype).eps * w.abs()
        assert bool(((g - w).abs() <= bar).all()), name


@pytest.mark.parametrize(
    "B,L,DI,ST,R,dtype,with_dh",
    [
        (4, 4096, 8192, 16, 256, torch.bfloat16, False),  # falcon-mamba-7b's training shape
        (4, 4096, 8192, 16, 256, torch.float32, False),
        (2, 1001, 200, 16, None, torch.bfloat16, False),  # L off the 8-step chunk, DI off the block
        (2, 333, 520, 64, None, torch.float32, False),    # 4 lanes a channel
        (2, 100, 100, 128, 8, torch.bfloat16, False),     # 8 lanes a channel, strided
        (2, 500, 300, 16, 8, torch.float32, True),        # a gradient for h_final
        (1, 19, 33, 5, 3, torch.float16, True),           # DI odd, b and c rows off 16 bytes
        (3, 1, 8, 1, None, torch.float32, True),          # one step, one state
        (2, 40, 72, 24, None, torch.bfloat16, False),     # states padded to 32
    ],
)
def test_mamba_bwd_kernel_matches_plain(cuda, B, L, DI, ST, R, dtype, with_dh):
    """The backward on the forward kernel's checkpoints, as SelectiveScanFn
    calls it, against the plain backward (which recomputes the states)."""
    args = _mamba_inputs(cuda, B, L, DI, ST, dtype, R=R)
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(B, L, DI, generator=gen, device=cuda)
    dh = torch.randn(B, DI, ST, generator=gen, device=cuda) if with_dh else None
    ckpt = mamba_scan(*args, checkpoints=True)[2]
    got = mamba_scan_bwd(*args, dy, dh, ckpt)
    torch.cuda.synchronize()
    _assert_mamba_bwd_close(got, ref_mamba_scan_bwd(*args, dy, dh), dtype)


@pytest.mark.parametrize(
    "B,L,DI,ST,R,dtype",
    [
        (4, 4096, 8192, 16, 256, torch.bfloat16),  # falcon-mamba-7b's training shape
        (2, 1001, 200, 16, None, torch.bfloat16),  # L off the 8- and 16-step chunks
        (2, 333, 520, 64, None, torch.float32),    # 4 lanes a channel in the forward
        (2, 100, 100, 128, 8, torch.bfloat16),     # 8 lanes a channel, strided
        (1, 19, 33, 5, 3, torch.float16),          # DI odd, rows off 16 bytes: plain loads
        (2, 40, 72, 24, None, torch.float32),      # states padded to 32 and to 24 in the checkpoints
        (3, 8, 8, 1, None, torch.float32),         # one chunk: no checkpoint
    ],
)
def test_mamba_scan_with_checkpoints_matches_serving_call_and_plain(cuda, B, L, DI, ST, R, dtype):
    """The forward with checkpoints gives the serving call's y and h to the
    bit, and checkpoints within 1e-4 of their max of the plain forward's
    (the state after every 8 steps, states past ST zero)."""
    args = _mamba_inputs(cuda, B, L, DI, ST, dtype, R=R)
    y, h = mamba_scan(*args)
    y_ck, h_ck, ckpt = mamba_scan(*args, checkpoints=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y_ck) and torch.equal(h, h_ck)
    want = ref_mamba_scan(*args, checkpoints=True)[2]
    assert ckpt.dtype == torch.float32 and ckpt.shape == want.shape
    if ckpt.numel():
        assert float((ckpt - want).abs().max()) <= 1e-4 * float(want.abs().max())
        assert not ckpt[..., ST:].any()


@pytest.mark.parametrize("ST,dtype", [(16, torch.bfloat16), (16, torch.float32),
                                      (64, torch.float16), (128, torch.float32)])
def test_mamba_bwd_kernel_is_deterministic(cuda, ST, dtype):
    """No float atomics: two launches give the same bits."""
    args = _mamba_inputs(cuda, 3, 300, 400, ST, dtype, R=8)
    dy = torch.randn(3, 300, 400, device=cuda)
    dh = torch.randn(3, 400, ST, device=cuda)
    ckpt = mamba_scan(*args, checkpoints=True)[2]
    first = mamba_scan_bwd(*args, dy, dh, ckpt)
    second = mamba_scan_bwd(*args, dy, dh, ckpt)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("sms", [1, 78, 132])
def test_backward_scratch_sizes_equal_the_librarys(cuda, sms):
    """The wrappers size the backward kernels' scratch themselves (so the dry
    run sees it); each size must be the one the library asks for."""
    import itertools

    from repro_torch.kernels import mamba_scan as scan_mod

    _, attn_ws = attn_mod._bwd_entries("wgmma")
    for (B, H, KV, Sq, Sk), D in itertools.product(
            [(1, 16, 1, 4096, 4096), (4, 32, 8, 1000, 1000), (1, 8, 1, 512, 512),
             (2, 16, 16, 4096, 4096), (1, 16, 1, 100, 100), (4, 32, 8, 4096, 1601),
             (1, 3, 1, 65, 65)], (16, 64, 72, 80, 96, 128, 136, 200, 256)):
        assert attn_mod.bwd_work_bytes(B, H, KV, Sq, Sk, D, sms) == attn_ws(
            B, H, KV, Sq, Sk, D, sms), (B, H, KV, Sq, Sk, D)
    _, scan_ws = scan_mod._bwd_entries()
    for B, L, DI, ST in itertools.product((1, 4), (7, 4096), (16, 500, 8192),
                                          (1, 4, 16, 17, 32, 33, 64, 65, 128)):
        assert scan_mod.bwd_work_bytes(B, L, DI, ST) == scan_ws(B, L, DI, ST), (B, L, DI, ST)


def test_mamba_bwd_wrapper_refuses_what_it_does_not_take(cuda):
    xc, dt, a, b, c, d = _mamba_inputs(cuda, 1, 8, 16, 8, torch.float32)
    dy = torch.randn(1, 8, 16, device=cuda)
    ck = mamba_scan(xc, dt, a, b, c, d, checkpoints=True)[2]
    with pytest.raises(ValueError, match="dy"):
        mamba_scan_bwd(xc, dt, a, b, c, d, dy.half(), None, ck)
    with pytest.raises(ValueError, match="dy"):
        mamba_scan_bwd(xc, dt, a, b, c, d, dy[:, :4], None, ck)
    with pytest.raises(ValueError, match="dh"):
        mamba_scan_bwd(xc, dt, a, b, c, d, dy, torch.randn(1, 16, 4, device=cuda), ck)
    with pytest.raises(ValueError, match="dh"):
        mamba_scan_bwd(xc, dt, a, b, c, d, dy, torch.randn(1, 16, 8, device=cuda).double(), ck)
    with pytest.raises(ValueError, match="share"):
        mamba_scan_bwd(xc, dt, a, b.half(), c, d, dy, None, ck)
    with pytest.raises(ValueError, match="float32"):
        mamba_scan_bwd(xc, dt.half(), a, b, c, d, dy, None, ck)
    with pytest.raises(ValueError, match="shapes"):
        mamba_scan_bwd(xc, dt, a, b[:, :4], c, d, dy, None, ck)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_bwd(xc, dt, a, b, c, d.cpu(), dy, None, ck)
    wide = _mamba_inputs(cuda, 1, 8, 16, 129, torch.float32)
    with pytest.raises(ValueError, match="out of range"):
        mamba_scan_bwd(*wide, dy, None, ck)
    long = _mamba_inputs(cuda, 1, 20, 16, 8, torch.float32)
    dy_long = torch.randn(1, 20, 16, device=cuda)
    ckpt = mamba_scan(*long, checkpoints=True)[2]
    assert ckpt.shape == (1, 2, 16, 8)
    off16 = torch.empty(ckpt.numel() + 1, device=cuda)[1:].view(ckpt.shape)  # contiguous, 4 B in
    for bad in (ckpt[:, :1], ckpt.double(), ckpt.transpose(1, 2).contiguous().transpose(1, 2),
                ckpt.cpu(), off16):
        with pytest.raises(ValueError, match="ckpt"):
            mamba_scan_bwd(*long, dy_long, None, bad)


def test_selective_scan_under_grad_counts_one_backward(cuda, monkeypatch):
    """Under grad, ``ops.selective_scan`` goes through SelectiveScanFn: one
    forward launch (the serving kernel's bits), one backward call when
    autograd asks (all six gradients in it), the kernel's gradients; under
    no_grad no graph."""
    for name in ("selective_scan_launches", "selective_scan_bwd_launches"):
        monkeypatch.setattr(ops, name, 0)
    args = _mamba_inputs(cuda, 2, 100, 256, 16, torch.bfloat16, R=8)
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    y, h = ops.selective_scan(*leaves)
    assert type(y.grad_fn).__name__ == "SelectiveScanFnBackward"
    ky, kh = mamba_scan(*args)
    assert torch.equal(y, ky) and torch.equal(h, kh)
    dy = torch.randn(2, 100, 256, device=cuda)
    got = torch.autograd.grad(y, leaves, dy)
    assert (ops.selective_scan_launches, ops.selective_scan_bwd_launches) == (1, 1)
    want = mamba_scan_bwd(*args, dy, None, mamba_scan(*args, checkpoints=True)[2])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        assert ops.selective_scan(*leaves)[0].grad_fn is None
    assert ops.selective_scan_bwd_launches == 1


@pytest.mark.parametrize("remat", ["full", "none"])
def test_mamba_train_step_on_card_matches_cpu(cuda, monkeypatch, remat):
    """A narrow fp32 Mamba (d_model 256, ssm_state 16, 2 layers) on two
    sequences of 77 tokens, longer than the backward's 8-step chunk: the loss
    and every gradient, ``a_log`` and ``d_skip`` included, within 1e-4 of the
    leaf's max of the CPU's, and one forward launch a layer (two under remat
    "full") and one backward launch a layer."""
    for name in ("selective_scan_launches", "selective_scan_bwd_launches"):
        monkeypatch.setattr(ops, name, 0)
    cfg = dataclasses.replace(_narrow_recurrent_config("falcon-mamba-7b"), n_layers=2)
    m_cpu = lm.init(0, cfg, device="cpu")
    m_gpu = lm.init(0, cfg, device=cuda)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(6))
    grads = {}
    for name, m, t in (("cpu", m_cpu, toks), ("card", m_gpu, toks.to(cuda))):
        m.requires_grad_(True)
        params = dict(m.named_parameters())
        loss, _ = lm.loss_fn(m, {"tokens": t}, cfg, remat=remat)
        grads[name] = (float(loss.detach()), dict(zip(params, torch.autograd.grad(loss, list(
            params.values())))))
    L_ = cfg.n_layers
    fwd = 2 * L_ if remat == "full" else L_
    assert (ops.selective_scan_launches, ops.selective_scan_bwd_launches) == (fwd, L_)
    (lc, gc_), (lg, gg) = grads["cpu"], grads["card"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert any("a_log" in n for n in gc_) and any("d_skip" in n for n in gc_)
    for name, want in gc_.items():
        bar = 1e-4 * float(want.abs().max())
        assert float((gg[name].cpu() - want).abs().max()) <= bar, name


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


def _assert_bag_bits(out, tables, ids):
    """Bitwise the sum in j's order; at one id a bag bitwise the plain
    version too; within test_kernels.py's bars of it otherwise."""
    assert torch.equal(out, ref_embedding_bag_in_order(tables, ids))
    if ids.shape[2] == 1:
        assert torch.equal(out, ref_embedding_bag(tables, ids))
    _assert_bag_close(out, ref_embedding_bag(tables, ids), tables, ids.shape[2])


@pytest.mark.parametrize("NNZ", [1, 3, 32])
@pytest.mark.parametrize("E", [128, 64, 13])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_bag_kernel_at_unit_edges(cuda, monkeypatch, dtype, id_dtype, E, NNZ):
    """With the units sized for a card of one SM, B * T bags (T = 1) at 1
    and at the first, second and last batch of up to 1024 that the kernel's
    split gives each unit G: every G from 1 to its cap (rows // NNZ) comes
    up, with ragged last units and groups that stop at different units."""
    monkeypatch.setattr(bag_mod, "sm_count", lambda index: 1)
    tables, _ = _bag_inputs(cuda, 1, 1000, E, 1, 1, dtype, id_dtype)
    one = torch.zeros((1, 1, NNZ), dtype=id_dtype, device=cuda)
    by_unit = {}  # G -> the batches it takes, in order
    for n in range(1, 1025):
        by_unit.setdefault(bag_fwd_split(tables, one.expand(n, 1, NNZ))["unit"], []).append(n)
    cap = max(1, bag_fwd_split(tables, one)["rows"] // NNZ)
    assert sorted(by_unit) == list(range(1, cap + 1))
    gen = torch.Generator(device=cuda).manual_seed(NNZ)
    for ns in by_unit.values():
        for n in sorted({1, ns[0], ns[min(1, len(ns) - 1)], ns[-1]}):
            ids = torch.randint(0, 1000, (n, 1, NNZ), generator=gen, device=cuda).to(id_dtype)
            _assert_bag_bits(embedding_bag(tables, ids), tables, ids)


@pytest.mark.parametrize("NNZ", [1, 32])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_bag_kernel_at_the_scoring_shape(cuda, dtype, id_dtype, NNZ):
    """The DLRM scoring batch (B = 4096, T = 8, E = 128) on tables cut to R =
    20000: at one id a bag a unit of the most rows a lane has in flight
    (more units than the card holds groups, so each group walks several,
    the next unit's ids in flight), at 32 a bag alone; with ids past the
    table too."""
    tables, ids = _bag_inputs(cuda, 8, 20_000, 128, 4096, NNZ, dtype, id_dtype, seed=5)
    ids[::97, :, 0] = torch.tensor([-1, 20_000, -20_001, 2**31 - 1, 0, 19_999, -7, 3],
                                   device=cuda).to(id_dtype)
    split = bag_fwd_split(tables, ids)
    assert split["unit"] == (split["rows"] if NNZ == 1 else 1)
    _assert_bag_bits(embedding_bag(tables, ids), tables, ids)


@pytest.mark.parametrize("sms", [1, 2, 4, None])
@pytest.mark.parametrize("NNZ", [1, 5, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bag_kernel_gives_the_same_bits_on_any_unit(cuda, monkeypatch, dtype, NNZ, sms):
    """The units and grid sized for cards of 1, 2 and 4 SMs (at one id a
    bag, up to 4 bags a unit) and for this one: the same bits as this
    card's and as the sum in j's order."""
    tables, ids = _bag_inputs(cuda, 3, 1000, 128, 301, NNZ, dtype, torch.int32, seed=6)
    want = embedding_bag(tables, ids)
    if sms:
        monkeypatch.setattr(bag_mod, "sm_count", lambda index: sms)
    out = embedding_bag(tables, ids)
    assert torch.equal(out, want)
    _assert_bag_bits(out, tables, ids)


@pytest.mark.parametrize("NNZ", [1, 32])
def test_bag_kernel_takes_strided_views_at_each_width(cuda, NNZ):
    """E = 64 and E = 13 as column slices of 16-byte rows (16-byte loads, a
    scalar tail at 13), transposed and unaligned tables (one value a lane),
    with strided ids: bitwise the sum in j's order and the contiguous
    copies' lookup."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    big = torch.randn(3, 400, 80, generator=gen, device=cuda)
    wide = torch.randint(-50, 450, (37, 3, 2 * NNZ), generator=gen, device=cuda)
    for ids in (wide[:, :, ::2], wide[:, :, :NNZ].transpose(0, 1).contiguous().transpose(0, 1)):
        for tables in (big[:, :, :64], big[:, :, :13], big[:, ::3, 8:72],
                       big.transpose(1, 2).contiguous().transpose(1, 2)[:, :, :13],
                       big[:, :, 1:14]):
            out = embedding_bag(tables, ids)
            assert torch.equal(out, embedding_bag(tables.contiguous(), ids.contiguous()))
            _assert_bag_bits(out, tables, ids)


@pytest.mark.parametrize("NNZ", [1, 32])
def test_bag_kernel_offsets_past_int32_in_j_order(cuda, NNZ):
    """fp32 tables (3, 6e6, 128): table 2 starts 1.5e9 elements in and its
    last rows lie 2.3e9 in, past INT_MAX (9.2 GB); int64 ids near R - 1."""
    T, R, E = 3, 6_000_000, 128
    tables = torch.randn(T, R, E, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    ids = torch.randint(R - 1000, R, (512, T, NNZ), generator=gen, device=cuda)
    _assert_bag_bits(embedding_bag(tables, ids), tables, ids)


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


def _bag_bwd_inputs(device, T, R, E, B, NNZ, dtype, id_dtype, kind="uniform", seed=0):
    """dout (B, T, E) and ids (B, T, NNZ): uniform in [0, R), drawn from 8
    rows a table (long runs), or from [-2R, 2R) (some dropped)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dout = torch.randn(B, T, E, generator=gen, device=device).to(dtype)
    if kind == "hot":
        hot = torch.randint(0, R, (8,), generator=gen, device=device)
        ids = hot[torch.randint(0, 8, (B, T, NNZ), generator=gen, device=device)]
    elif kind == "outside":
        ids = torch.randint(-2 * R, 2 * R, (B, T, NNZ), generator=gen, device=device)
    else:
        ids = torch.randint(0, R, (B, T, NNZ), generator=gen, device=device)
    return dout, ids.to(id_dtype)


@pytest.mark.parametrize("tiling", BWD_TILINGS)
@pytest.mark.parametrize("kind", ["uniform", "hot", "outside"])
@pytest.mark.parametrize("NNZ", [1, 7, 32])
@pytest.mark.parametrize("E", [128, 16, 13, 200])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_bag_bwd_kernel_matches_plain(cuda, dtype, id_dtype, E, NNZ, kind, tiling):
    """Bitwise the plain version on the CPU, which adds in the kernel's (b, j)
    order in fp32 and rounds once; within the forward's bars of the plain
    version on the card, whose index_add_ adds in no fixed order.  Each
    tiling forced (B * T * NNZ <= 480: both take it)."""
    dout, ids = _bag_bwd_inputs(cuda, 3, 1000, E, 5, NNZ, dtype, id_dtype, kind)
    out = embedding_bag_bwd(dout, ids, 1000, dtype, tiling)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (3, 1000, E)
    assert torch.equal(out.cpu(), ref_embedding_bag_bwd(dout.cpu(), ids.cpu(), 1000, dtype))
    expect = ref_embedding_bag_bwd(dout, ids, 1000, dtype)
    if dtype == torch.float32:
        # B * NNZ = 5 * NNZ: the longest run a row can have.
        atol = 5 * NNZ * torch.finfo(torch.float32).eps * float(dout.abs().max())
        torch.testing.assert_close(out, expect, rtol=1e-6, atol=atol)
    else:
        torch.testing.assert_close(out.float(), expect.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bag_bwd_kernel_is_deterministic(cuda, dtype):
    """Rows that 4096 x 32 ids (8 hot rows a table) hit thousands of times:
    two launches give the same bits (the sorted tiling: n > N_SMALL)."""
    dout, ids = _bag_bwd_inputs(cuda, 2, 5000, 128, 4096, 32, dtype, torch.int32, "hot")
    assert bag_bwd_tiling(ids.numel()) == "sorted"
    first = embedding_bag_bwd(dout, ids, 5000, dtype)
    assert torch.equal(first, embedding_bag_bwd(dout, ids, 5000, dtype))
    assert torch.equal(first.cpu(), ref_embedding_bag_bwd(dout.cpu(), ids.cpu(), 5000, dtype))


@pytest.mark.parametrize("tiling", BWD_TILINGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bag_bwd_tiling_gives_the_same_bits_twice(cuda, dtype, tiling):
    """128 x 2 x 32 ids from 8 hot rows a table (n = N_SMALL, both tilings
    take it; runs of about 500): two launches of one tiling equal, and
    equal to the other tiling and the CPU's plain version."""
    dout, ids = _bag_bwd_inputs(cuda, 2, 5000, 128, 128, 32, dtype, torch.int32, "hot")
    assert ids.numel() == N_SMALL
    first = embedding_bag_bwd(dout, ids, 5000, dtype, tiling)
    assert torch.equal(first, embedding_bag_bwd(dout, ids, 5000, dtype, tiling))
    other = "sorted" if tiling == "small" else "small"
    assert torch.equal(first, embedding_bag_bwd(dout, ids, 5000, dtype, other))
    assert torch.equal(first.cpu(), ref_embedding_bag_bwd(dout.cpu(), ids.cpu(), 5000, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["uniform", "hot", "outside"])
@pytest.mark.parametrize("shape", [(128, 2, 1), (128, 64, 1), (64, 2, 4), (4096, 2, 1)])
def test_bag_bwd_tilings_agree_bitwise(cuda, shape, kind, dtype):
    """Each tiling forced on the same inputs at the DLRM shapes the small
    tiling serves (the training batch, 64 tables, multi-hot, B = 4096):
    bitwise equal to each other and to the CPU's plain version; fp32 within
    rtol 1e-6 and (the longest run) ulps of the plain version on the card
    (index_add_ adds in no fixed order there), bf16 within 2e-2."""
    B, T, NNZ = shape
    R = 10_000
    dout, ids = _bag_bwd_inputs(cuda, T, R, 128, B, NNZ, dtype, torch.int32, kind)
    assert bag_bwd_tiling(ids.numel()) == "small"
    small = embedding_bag_bwd(dout, ids, R, dtype, "small")
    assert torch.equal(small, embedding_bag_bwd(dout, ids, R, dtype))  # the default
    assert torch.equal(small, embedding_bag_bwd(dout, ids, R, dtype, "sorted"))
    assert torch.equal(small.cpu(), ref_embedding_bag_bwd(dout.cpu(), ids.cpu(), R, dtype))
    expect = ref_embedding_bag_bwd(dout, ids, R, dtype)
    if dtype == torch.float32:
        atol = B * NNZ * torch.finfo(torch.float32).eps * float(dout.abs().max())
        torch.testing.assert_close(small, expect, rtol=1e-6, atol=atol)
    else:
        torch.testing.assert_close(small.float(), expect.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_bag_bwd_at_the_small_boundary(cuda, extra):
    """n = N_SMALL - 1, N_SMALL, N_SMALL + 1 entries in one table (T = 1: up
    to 64 KB of staged keys in a block), ids from 8 hot rows: the default
    tiling is ``bag_bwd_tiling``'s, it equals the sorted tiling's bits, and
    the small tiling refuses past N_SMALL."""
    B = N_SMALL + extra
    dout, ids = _bag_bwd_inputs(cuda, 1, 5000, 128, B, 1, torch.float32, torch.int64, "hot")
    out = embedding_bag_bwd(dout, ids, 5000, torch.float32)
    assert torch.equal(out, embedding_bag_bwd(dout, ids, 5000, torch.float32, "sorted"))
    assert torch.equal(out.cpu(), ref_embedding_bag_bwd(dout.cpu(), ids.cpu(), 5000,
                                                        torch.float32))
    if extra <= 0:
        assert torch.equal(out, embedding_bag_bwd(dout, ids, 5000, torch.float32, "small"))
    else:
        with pytest.raises(ValueError, match="does not take"):
            embedding_bag_bwd(dout, ids, 5000, torch.float32, "small")


@pytest.mark.parametrize("R", [100, 2**31 + 8])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_sorted_keys_on_the_card_equal_the_cpus(cuda, id_dtype, R):
    """The keys kernel (one pass) then the stable sort: the same keys and
    positions as the plain steps on the CPU, at strided ids too, with int32
    keys (R = 100) and int64 keys (R past INT_MAX, ids within a few rows of
    R, or of 2^31 - 1 for int32 ids)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    ids = torch.randint(-200, 300, (40, 3, 5), generator=gen, device=cuda)
    if R > 2**31:
        shift = R - 200 if id_dtype == torch.int64 else 2**31 - 1 - 300
        ids = torch.where(ids >= 0, ids + shift, ids)
    ids = ids.to(id_dtype)
    for view in (ids, ids.transpose(0, 1).contiguous().transpose(0, 1), ids[:, :, ::2]):
        keys, pos = sorted_keys(view, R)
        want_keys, want_pos = sorted_keys(view.cpu(), R)
        assert keys.dtype == key_dtype(3, R)
        assert torch.equal(keys.cpu(), want_keys) and torch.equal(pos.cpu(), want_pos)


@pytest.mark.parametrize("tiling", BWD_TILINGS)
def test_bag_bwd_kernel_takes_strided_dout(cuda, tiling):
    """dout as DLRM's backward hands it (a (B, T, E) slice of the (B, T + 1,
    E) gradient of the features), transposed, not 16-byte aligned, and
    expanded, with strided ids: the same rows as from contiguous copies."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    big = torch.randn(6, 4, 16, generator=gen, device=cuda)
    ids = torch.randint(-5, 60, (6, 3, 4), generator=gen, device=cuda)
    views = [big[:, 1:], big[:, 1:].transpose(0, 1).contiguous().transpose(0, 1),
             big[:, 1:, 1:14], torch.ones(1, 1, 16, device=cuda).expand(6, 3, 16)]
    for dout in views:
        out = embedding_bag_bwd(dout, ids, 50, torch.float32, tiling)
        assert torch.equal(out, embedding_bag_bwd(dout.contiguous(), ids, 50, torch.float32,
                                                  tiling))
        assert torch.equal(out.cpu(), ref_embedding_bag_bwd(dout.cpu(), ids.cpu(), 50,
                                                             torch.float32))
    wide = torch.randint(-5, 60, (6, 3, 8), generator=gen, device=cuda)[:, :, ::2]
    out = embedding_bag_bwd(views[0], wide, 50, torch.float32, tiling)
    assert torch.equal(out, embedding_bag_bwd(views[0], wide.contiguous(), 50, torch.float32,
                                              tiling))


@pytest.mark.parametrize("tiling", BWD_TILINGS)
def test_bag_bwd_kernel_offsets_past_int32(cuda, tiling):
    """Table 1 of (2, 1e7, 128) starts 1.28e9 elements in and its last rows
    lie 2.56e9 in, past INT_MAX (bf16: 5.12 GB)."""
    T, R, E = 2, 10_000_000, 128
    gen = torch.Generator(device=cuda).manual_seed(4)
    dout = torch.randn(64, T, E, generator=gen, device=cuda).bfloat16()
    ids = torch.randint(R - 1000, R, (64, T, 4), generator=gen, device=cuda)
    out = embedding_bag_bwd(dout, ids, R, torch.bfloat16, tiling)
    keys = (ids + torch.arange(T, device=cuda)[None, :, None] * R).reshape(-1).unique()
    rows = out.view(T * R, E)
    expect = torch.zeros(T * R, E, device=cuda).index_add_(
        0, (ids + torch.arange(T, device=cuda)[None, :, None] * R).reshape(-1),
        dout.float()[:, :, None, :].expand(64, T, 4, E).reshape(-1, E))
    torch.testing.assert_close(rows[keys].float(), expect[keys], rtol=2e-2, atol=2e-2)
    assert int(rows.ne(0).any(dim=1).sum()) == keys.numel()  # zero elsewhere


def test_bag_bwd_keys_past_int32(cuda):
    """T * R past INT_MAX (one table of 2^31 + 8 rows, E = 1, fp16: 4.3 GB of
    gradient): the sorted tiling's keys are int64; both tilings write the
    same bits, each touched row the fp32 sum of its dout values in (b, j)
    order, rounded once, and no other row."""
    R = 2**31 + 8
    assert key_dtype(1, R) == torch.int64
    ids = torch.tensor([[[R - 1, 0, R - 1, 5]], [[R - 1, -1, 7, 0]]], device=cuda)
    dout = torch.tensor([[[0.3]], [[-1.7]]], device=cuda).half()
    got = embedding_bag_bwd(dout, ids, R, torch.float16, "sorted")
    assert torch.equal(got, embedding_bag_bwd(dout, ids, R, torch.float16, "small"))
    d0, d1 = dout.float().cpu().view(2).numpy()

    def f32(*xs):  # added one by one in fp32 from 0, then rounded once
        acc = np.float32(0)
        for x in xs:
            acc = np.float32(acc + x)
        return torch.tensor(acc).half()

    want = {R - 1: f32(d0, d0, d1, d1), 0: f32(d0, d1), 5: f32(d0), 7: f32(d1)}
    for row, value in want.items():
        assert torch.equal(got[0, row, 0].cpu(), value)
    assert int(got.ne(0).sum()) == len(want)


@pytest.mark.parametrize("tiling", BWD_TILINGS)
def test_bag_bwd_wrapper_refuses_what_it_does_not_take(cuda, tiling):
    dout, ids = _bag_bwd_inputs(cuda, 2, 100, 16, 3, 2, torch.float32, torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        embedding_bag_bwd(dout, ids.cpu(), 100, torch.float32, tiling)
    with pytest.raises(ValueError, match="tables' dtype"):
        embedding_bag_bwd(dout, ids, 100, torch.bfloat16, tiling)
    with pytest.raises(ValueError, match="dout must be"):
        embedding_bag_bwd(dout.double(), ids, 100, torch.float64, tiling)
    with pytest.raises(ValueError, match="indices must be"):
        embedding_bag_bwd(dout, ids.short(), 100, torch.float32, tiling)
    with pytest.raises(ValueError, match="indices"):
        embedding_bag_bwd(dout, ids[:, :1], 100, torch.float32, tiling)
    with pytest.raises(ValueError, match="out of range"):
        embedding_bag_bwd(dout, ids, 0, torch.float32, tiling)
    with pytest.raises(ValueError, match="does not take"):
        embedding_bag_bwd(dout, ids, 100, torch.float32, tiling + "s")


@pytest.mark.parametrize("B,tiling", [(5, "small"), (N_SMALL, "sorted")])
def test_bag_lookup_counts_bwd_launches_by_tiling(cuda, monkeypatch, B, tiling):
    """ops.bag_lookup under grad: the backward's launch counted once, and once
    under the tiling ``bag_bwd_tiling`` picks (B x 3 x 4 entries)."""
    names = ("bag_lookup_bwd_launches", "bag_lookup_bwd_small_launches",
             "bag_lookup_bwd_sorted_launches")
    for name in names:
        monkeypatch.setattr(ops, name, 0)
    tables, _ = _bag_inputs(cuda, 3, 200, 16, B, 4, torch.float32, torch.int32)
    dout, ids = _bag_bwd_inputs(cuda, 3, 200, 16, B, 4, torch.float32, torch.int32, "hot")
    leaf = tables.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(ops.bag_lookup(leaf, ids), leaf, dout)
    assert bag_bwd_tiling(ids.numel()) == tiling
    assert [getattr(ops, n) for n in names] == [1, int(tiling == "small"),
                                                int(tiling == "sorted")]
    assert torch.equal(grad, embedding_bag_bwd(dout, ids, 200, torch.float32, tiling))


def test_bag_lookup_under_grad_launches_both_kernels(cuda, monkeypatch):
    """ops.bag_lookup on tables that need a gradient: one forward launch, one
    backward launch when autograd asks, the gradient bitwise the CPU's."""
    monkeypatch.setattr(ops, "bag_lookup_launches", 0)
    monkeypatch.setattr(ops, "bag_lookup_bwd_launches", 0)
    tables, _ = _bag_inputs(cuda, 3, 200, 16, 5, 4, torch.float32, torch.int32)
    dout, ids = _bag_bwd_inputs(cuda, 3, 200, 16, 5, 4, torch.float32, torch.int32, "outside")
    leaf = tables.clone().requires_grad_(True)
    out = ops.bag_lookup(leaf, ids)
    assert (ops.bag_lookup_launches, ops.bag_lookup_bwd_launches) == (1, 0)
    (grad,) = torch.autograd.grad(out, leaf, dout)
    assert (ops.bag_lookup_launches, ops.bag_lookup_bwd_launches) == (1, 1)
    assert torch.equal(out, embedding_bag(tables, ids))
    assert torch.equal(grad.cpu(), ref_embedding_bag_bwd(dout.cpu(), ids.cpu(), 200,
                                                          torch.float32))


def test_dlrm_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One narrow fp32 DLRM step of ``launch.dlrm_testbed.make_step`` (ids past
    the table and negative among them): the loss and every gradient within
    1e-5 of the leaf's max of the CPU's, and the parameters after the AdamW
    step within 1e-4 (AdamW's g / (|g| + eps) near g = 0)."""
    from repro_torch.launch.dlrm_testbed import make_step

    cfg = dlrm.DLRMConfig(n_tables=4, rows_per_table=1000, embed_dim=16,
                          bottom_mlp=(32, 32), top_mlp=(32, 32, 1))
    models = {d: dlrm.init(0, cfg, device=d) for d in ("cpu", cuda)}
    models[cuda].load_state_dict(models["cpu"].state_dict())
    gen = torch.Generator().manual_seed(0)
    sparse = torch.randint(-1500, 2500, (64, cfg.n_tables), generator=gen)
    batch = {"dense": torch.randn(64, cfg.dense_features, generator=gen), "sparse": sparse,
             "label": (sparse[:, 0] % 2).float()}
    grads, losses = {}, {}
    for d, m in models.items():
        m.requires_grad_(True)
        params = dict(m.named_parameters())
        loss, _ = dlrm.loss_fn(m, {k: v.to(d) for k, v in batch.items()}, cfg)
        grads[d] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses[d] = float(loss.detach())
    assert abs(losses[cuda] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])
    for n, g in grads["cpu"].items():
        err = float((grads[cuda][n].cpu() - g).abs().max())
        assert err <= 1e-5 * float(g.abs().max()), (n, err)
    monkeypatch.setattr(ops, "bag_lookup_bwd_launches", 0)
    for d, m in models.items():
        opt = optim.adamw(optim.constant(3e-3), weight_decay=0.0)
        make_step(cfg, opt)(m, opt.init(dict(m.named_parameters())),
                            {k: v.to(d) for k, v in batch.items()}, 0)
    assert ops.bag_lookup_bwd_launches == 1
    for n, p in models["cpu"].named_parameters():
        err = float((dict(models[cuda].named_parameters())[n].detach().cpu() - p.detach())
                    .abs().max())
        assert err <= 1e-4 * float(p.detach().abs().max()), (n, err)


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
@pytest.mark.parametrize("D", [64, 80, 128, 256])
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
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_bwd_kernel_is_deterministic(cuda, tiling, D):
    """No atomics: every sum runs in a fixed order, so repeated launches give
    the same bits (GQA 4:1, so dk and dv sum over 4 heads; at D = 256 on
    wgmma in partials over the heads)."""
    q, k, v = _qkv(cuda, 2, 8, 2, 300, 300, D, torch.bfloat16, seed=6)
    do = torch.randn_like(q)
    lse = torch.empty(2, 8, 300, device=cuda)
    o = flash_attention(q, k, v, lse=lse)
    first = flash_attention_bwd(q, k, v, o, lse, do, tiling=tiling)
    for _ in range(3):
        again = flash_attention_bwd(q, k, v, o, lse, do, tiling=tiling)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("D", [257, 320])
def test_bwd_kernel_refuses_head_dims_it_does_not_take(cuda, D):
    q, k, v = _qkv(cuda, 1, 2, 2, 64, 64, D, torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match=f"head dim {D}"):
        flash_attention_bwd(q, k, v, q, lse, q)


@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D",
    [
        (1, 16, 16, 4096, 4096, 80),  # hubert-xlarge's training attention, one sequence
        (1, 32, 8, 4096, 1601, 128),  # llama-3.2-vision-11b's cross-attention to its image
    ],
)
def test_bwd_kernel_at_the_unmasked_training_shapes(cuda, B, H, KV, Sq, Sk, D):
    """The two unmasked training shapes of the audio encoder and the VLM's
    cross layers on the wgmma tiling: dq, dk, dv within the bf16 bar of
    autograd of the plain version, and the same bits twice."""
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, D, torch.bfloat16, seed=10)
    do = torch.randn_like(q)
    lse = torch.empty(B, H, Sq, device=cuda)
    o = flash_attention(q, k, v, causal=False, lse=lse)
    got = flash_attention_bwd(q, k, v, o, lse, do, False, 0, tiling="wgmma")
    again = flash_attention_bwd(q, k, v, o, lse, do, False, 0, tiling="wgmma")
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for g, want in zip(got, _plain_grads(q, k, v, do, False, 0)):
        err = float((g.float() - want).abs().max())
        assert err <= TOL[torch.bfloat16] * float(want.abs().max()), err


@pytest.mark.parametrize("sms", [1, 8, 64, 132, 1 << 20])
@pytest.mark.parametrize("B,H,KV,S,window", [(1, 16, 1, 1000, 256), (2, 8, 2, 300, 0),
                                             (1, 16, 1, 129, 64)])
def test_bwd_d256_head_splits_match_plain(cuda, monkeypatch, sms, B, H, KV, S, window):
    """At D = 256 the wgmma dk/dv launch cuts a kv head's query heads into as
    many fp32 partials as fill the card's SMs (recurrentgemma-9b: GQA 16:1).
    Launches sized for other SM counts (the wrapper's ``sm_count``
    monkeypatched; 1 and 1 << 20: no split, one head a split) hold dq, dk,
    dv to autograd of the plain version at the bf16 bar, and each gives the
    same bits twice."""
    monkeypatch.setattr(attn_mod, "sm_count", lambda index: sms)
    q, k, v = _qkv(cuda, B, H, KV, S, S, 256, torch.bfloat16, seed=9)
    do = torch.randn_like(q)
    lse = torch.empty(B, H, S, device=cuda)
    o = flash_attention(q, k, v, causal=True, window=window, lse=lse)
    got = flash_attention_bwd(q, k, v, o, lse, do, True, window, tiling="wgmma")
    again = flash_attention_bwd(q, k, v, o, lse, do, True, window, tiling="wgmma")
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for g, want in zip(got, _plain_grads(q, k, v, do, True, window)):
        err = float((g.float() - want).abs().max())
        assert err <= TOL[torch.bfloat16] * float(want.abs().max()), err


# Head dim 80 on wgmma: the forward's own kernel (true-width products, 128-key
# tiles) and the backward's dk/dv items, which also add dQ in turns.  (B, H,
# KV, Sq, Sk, causal, window): Sq and Sk off a multiple of 64 (the 16-column
# box's ragged tails), causal GQA 4:1 and with a window (fewer items than the
# H100's 132 SMs), and S = 4096 unmasked with six heads (192 items, 32 of a
# kv head sharing each query tile's turns).
D80_CASES = [
    (2, 4, 4, 333, 200, False, 0),
    (2, 4, 4, 200, 333, False, 0),
    (1, 8, 2, 333, 333, True, 0),
    (1, 8, 2, 300, 300, True, 100),
    (1, 8, 2, 300, 300, False, 100),
    (1, 6, 6, 4096, 4096, False, 0),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,window", D80_CASES)
def test_d80_kernels_match_plain_and_repeat_their_bits(cuda, B, H, KV, Sq, Sk, causal, window,
                                                       dtype):
    """The D = 80 forward within the bar of the plain version and its lse
    within 1e-4, the backward within the bar of autograd of the plain
    version, and two launches of each the same bits."""
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, 80, dtype, seed=11)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(12),
                     device=cuda).to(dtype)
    lse = torch.empty(B, H, Sq, device=cuda)
    o = flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    o2 = flash_attention(q, k, v, causal=causal, window=window)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling="wgmma")
    again = flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling="wgmma")
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ref_flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(o.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(lse, ref_flash_attention_lse(q, k, v, causal=causal, window=window),
                               rtol=1e-5, atol=1e-4)
    for g, want in zip(got, _plain_grads(q, k, v, do, causal, window)):
        err = float((g.float() - want).abs().max())
        assert err <= TOL[dtype] * float(want.abs().max()), err


def test_d80_bwd_starts_afresh_after_another_shape(cuda):
    """The turn counters are zeroed on every call and every query tile's
    first turn stores its sum, so each of three shapes (more and fewer
    query tiles and items, another scratch), called straight after another,
    gives the bits of its own first call."""
    def grads(B, H, KV, S, causal, seed):
        q, k, v = _qkv(cuda, B, H, KV, S, S, 80, torch.bfloat16, seed=seed)
        do = torch.randn_like(q)
        lse = torch.empty(B, H, S, device=cuda)
        o = flash_attention(q, k, v, causal=causal, lse=lse)
        return lambda: flash_attention_bwd(q, k, v, o, lse, do, causal, 0, tiling="wgmma")

    calls = {"first": grads(2, 8, 2, 700, True, 13), "big": grads(1, 16, 16, 2048, False, 14),
             "small": grads(1, 2, 1, 130, True, 15)}
    want = {name: call() for name, call in calls.items()}
    for name in ("first", "big", "first", "small", "big", "small", "first"):
        assert all(torch.equal(a, b) for a, b in zip(calls[name](), want[name])), name


@pytest.mark.parametrize("sms", [1, 2, 7, 132, 1 << 20])
@pytest.mark.parametrize("B,H,KV,S,causal", [(1, 4, 2, 1000, True), (2, 4, 4, 1000, False)])
def test_d80_bwd_on_any_grid(cuda, monkeypatch, sms, B, H, KV, S, causal):
    """The dk/dv launch at D = 80 is persistent, at most one block an SM of
    the card whatever the SM count the wrapper passes: with 1, 2 and 7
    blocks, fewer than a kv head's 8 items, the walks are unstaggered and
    the turns in the order of the items; with 132 and 1 << 20 there is a
    block an item (16 and 64 items) and the walks are staggered.  Either
    way the gradients within the bar and the same bits twice."""
    monkeypatch.setattr(attn_mod, "sm_count", lambda index: sms)
    q, k, v = _qkv(cuda, B, H, KV, S, S, 80, torch.bfloat16, seed=16)
    do = torch.randn_like(q)
    lse = torch.empty(B, H, S, device=cuda)
    o = flash_attention(q, k, v, causal=causal, lse=lse)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, 0, tiling="wgmma")
    again = flash_attention_bwd(q, k, v, o, lse, do, causal, 0, tiling="wgmma")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, want in zip(got, _plain_grads(q, k, v, do, causal, 0)):
        err = float((g.float() - want).abs().max())
        assert err <= TOL[torch.bfloat16] * float(want.abs().max()), err


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
    q264, k264, v264 = _qkv(cuda, 1, 4, 2, 64, 64, 264, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 264"):
        flash_attention_bwd(q264, k264, v264, q264, torch.empty(1, 4, 64, device=cuda), q264)
    q36, k36, v36 = _qkv(cuda, 1, 4, 2, 64, 64, 36, torch.bfloat16)  # rows TMA cannot stride
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_bwd(q36, k36, v36, q36, torch.empty(1, 4, 64, device=cuda), q36,
                            tiling="wgmma")
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q[:, :, :200], k, v, q[:, :, :200], lse.half()[:, :, :200],
                            q[:, :, :200])


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


def test_hybrid_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One narrow fp32 recurrentgemma step (head dim 256, 5 layers: a (rec,
    rec, attn) block and the (rec, rec) tail, a 32-token window that the
    77-token sequences pass): loss, grad norm and every updated parameter
    within 1e-4 of the same step on the CPU, with 8 forward and 4 backward
    RG-LRU launches and 2 forward and 1 backward attention launches on the
    fma tiling (remat "full" runs each forward twice).  SGD, as above."""
    counters = ("lru_scan_launches", "lru_scan_bwd_launches", "attention_launches",
                "attention_bwd_launches", "attention_bwd_fma_launches")
    for name in counters:
        monkeypatch.setattr(ops, name, 0)
    cfg = dataclasses.replace(
        get_config("recurrentgemma-9b").smoke(), d_model=256, n_heads=2, n_kv_heads=1,
        head_dim=256, d_ff=512, lru_width=256, attn_window=32, n_layers=5,
        param_dtype="float32", activation_dtype="float32")
    m_cpu = lm.init(0, cfg, device="cpu")
    m_gpu = lm.init(0, cfg, device=cuda)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(4))
    opt = optim.sgd_momentum(optim.constant(0.1))
    step = make_train_step(cfg, opt)
    _, _, mc = step(m_cpu, opt.init(dict(m_cpu.named_parameters())), {"tokens": toks}, 0)
    _, _, mg = step(m_gpu, opt.init(dict(m_gpu.named_parameters())), {"tokens": toks.to(cuda)}, 0)
    assert {n: getattr(ops, n) for n in counters} == dict(
        lru_scan_launches=8, lru_scan_bwd_launches=4, attention_launches=2,
        attention_bwd_launches=1, attention_bwd_fma_launches=1)
    for key in ("loss", "xent", "grad_norm"):
        torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=1e-4, atol=1e-6)
    for (name, pg), pc in zip(m_gpu.named_parameters(), m_cpu.parameters()):
        bar = 1e-4 * float(pc.abs().max())
        assert float((pg.detach().cpu() - pc.detach()).abs().max()) <= bar, name


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_vlm_and_encoder_train_steps_on_card_match_cpu(cuda, family, monkeypatch):
    """One narrow fp32 train step of the VLM (head dim 128, 10 layers, two
    of them cross layers over 100 image tokens, the gates opened to 0.5) and
    of the encoder (head dim 80, 2 layers): loss, grad norm and every
    updated parameter within 1e-4 of the same step on the CPU, every
    attention on the fma tilings (the VLM's cross layers run once: they are
    not rematerialized).  SGD, as above."""
    counters = ("attention_launches", "attention_fma_launches", "attention_bwd_launches",
                "attention_bwd_fma_launches")
    for name in counters:
        monkeypatch.setattr(ops, name, 0)
    cfg = _narrow_vlm_and_encoder_configs()[family == "audio"]
    m_cpu = lm.init(0, cfg, device="cpu")
    for blk in m_cpu.blocks:
        if hasattr(blk.attn, "gate"):
            blk.attn.gate.fill_(0.5)
    m_gpu = lm.init(0, cfg, device=cuda)
    m_gpu.load_state_dict(m_cpu.state_dict())
    gen = torch.Generator().manual_seed(6)
    if family == "vlm":
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 77), generator=gen),
                 "image_embeds": torch.randn(2, cfg.img_tokens, cfg.d_model, generator=gen)}
    else:
        batch = {"frames": torch.randn(2, 77, cfg.d_model, generator=gen),
                 "labels": torch.randint(0, cfg.vocab, (2, 77), generator=gen)}
    opt = optim.sgd_momentum(optim.constant(0.1))
    step = make_train_step(cfg, opt, loss_chunk=32)
    _, _, mc = step(m_cpu, opt.init(dict(m_cpu.named_parameters())), batch, 0)
    _, _, mg = step(m_gpu, opt.init(dict(m_gpu.named_parameters())),
                    {k: v.to(cuda) for k, v in batch.items()}, 0)
    n_cross = cfg.n_layers // cfg.cross_attn_every if family == "vlm" else 0
    forward = 2 * (cfg.n_layers - n_cross) + n_cross
    assert {n: getattr(ops, n) for n in counters} == dict(
        attention_launches=forward, attention_fma_launches=forward,
        attention_bwd_launches=cfg.n_layers, attention_bwd_fma_launches=cfg.n_layers)
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


def test_online_admission_on_card_matches_cpu(cuda, monkeypatch):
    """``chip_smoke.py`` phase 6e's admission at N = 16: the default policy
    runs the fused co-search on the card and adopts the CPU's plan."""
    from repro_torch.core import alternating as alt
    from repro_torch.core import online
    from repro_torch.core.strategy_search import evaluate_jobset

    fused, seen = alt._co_optimize_fused, []
    monkeypatch.setattr(alt, "_co_optimize_fused",
                        lambda *a, **k: seen.append(k["device"]) or fused(*a, **k))

    def admit(device):
        residents = wl.JobSet(n=16, tenants=[
            wl.TenantJob(spec=wl.DLRM, weight=2.0, name="DLRM", servers=tuple(range(0, 4))),
            wl.TenantJob(spec=wl.BERT, name="BERT", servers=tuple(range(4, 8))),
            wl.TenantJob(spec=wl.CANDLE, name="CANDLE", servers=(8, 9))])
        policy = online.ReoptPolicy.reactive(replan_latency=0.0, candidates=4, chains=4,
                                             temperatures=pt.DEFAULT_TEMPER_LADDER,
                                             device=device)
        ctrl = online.JobSetController(residents, hw=PLAN_HW, policy=policy, seed=3)
        return ctrl, ctrl.admit(wl.VGG16, 4, name="VGG16", now=0.0)

    card, card_out = admit(None)
    cpu, cpu_out = admit("cpu")
    assert seen == [None, "cpu"]
    assert card_out == cpu_out and len(card_out[0]) == 4
    assert card.plan.candidate_index == cpu.plan.candidate_index
    assert card.plan.strategies == cpu.plan.strategies
    assert card.plan.iter_time == cpu.plan.iter_time
    assert sorted(card.topology.graph.edges()) == sorted(cpu.topology.graph.edges())
    assert "VGG16" in card.plan.strategies and not card.plan_violations(card.topology)
    repriced = evaluate_jobset(card.plan.strategies, card.jobset, card.plan.topology, PLAN_HW)
    assert repriced[0] == card.plan.iter_time


# Head dim 32 (the fp32 model of examples/train_lm_topoopt.py) on the fma
# tilings, forward and backward; wgmma does not take it.
D32_DTYPES = [torch.float32, torch.float16, torch.bfloat16]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,window", BWD_CASES)
@pytest.mark.parametrize("dtype", D32_DTYPES)
def test_d32_fma_forward_matches_plain(cuda, dtype, B, H, KV, Sq, Sk, causal, window):
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, 32, dtype, seed=7)
    lse = torch.empty(B, H, Sq, device=cuda)
    out = flash_attention(q, k, v, causal=causal, window=window, tiling="fma", lse=lse)
    again = flash_attention(q, k, v, causal=causal, window=window, tiling="fma")
    want = ref_flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and torch.equal(out, again)
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    want_lse = ref_flash_attention_lse(q, k, v, causal, window)
    assert float((lse - want_lse).abs().max()) <= 1e-4 * max(1.0, float(want_lse.abs().max()))


@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,window", BWD_CASES)
@pytest.mark.parametrize("dtype", D32_DTYPES)
def test_d32_fma_bwd_matches_autograd_of_plain(cuda, dtype, B, H, KV, Sq, Sk, causal, window):
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, 32, dtype, seed=8)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(9),
                     device=cuda).to(dtype)
    lse = torch.empty(B, H, Sq, device=cuda)
    o = flash_attention(q, k, v, causal=causal, window=window, tiling="fma", lse=lse)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling="fma")
    again = flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling="fma")
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, want, t in zip(got, _plain_grads(q, k, v, do, causal, window), (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        err = float((g.float() - want).abs().max())
        assert err <= TOL[dtype] * max(float(want.abs().max()), 1.0), err


def test_d32_runs_on_fma_and_wgmma_refuses_it(cuda, monkeypatch):
    """fp32 at head dim 32 goes through the fma kernels under autograd, 1
    forward and 1 backward launch.  bf16 at head dim 32, which the wgmma
    tiling once refused, now runs on it at width 64, 1 launch each way, and
    its gradients hold the bf16 bar."""
    for n in BWD_COUNTERS:
        monkeypatch.setattr(ops, n, 0)
    q, k, v = (t.requires_grad_(True) for t in _qkv(cuda, 2, 8, 4, 128, 128, 32, torch.float32))
    ops.attention(q, k, v).sum().backward()
    assert {n: getattr(ops, n) for n in BWD_COUNTERS} == dict(
        attention_launches=1, attention_wgmma_launches=0, attention_fma_launches=1,
        attention_bwd_launches=1, attention_bwd_wgmma_launches=0, attention_bwd_fma_launches=1)
    assert attn_mod.attention_tiling(torch.bfloat16, 32) == "wgmma"
    assert attn_mod.attention_bwd_tiling(torch.bfloat16, 32) == "wgmma"
    qb, kb, vb = (t.requires_grad_(True) for t in _qkv(cuda, 1, 2, 2, 64, 64, 32, torch.bfloat16))
    do = torch.randn_like(qb)
    got = torch.autograd.grad(ops.attention(qb, kb, vb), (qb, kb, vb), do)
    assert ops.attention_wgmma_launches == 1 and ops.attention_bwd_wgmma_launches == 1
    for g, want in zip(got, _plain_grads(qb.detach(), kb.detach(), vb.detach(), do, True, 0)):
        err = float((g.float() - want).abs().max())
        assert err <= TOL[torch.bfloat16] * max(float(want.abs().max()), 1.0), err


@pytest.mark.parametrize("kind", ["ring", "recursive_hd", "multi_tree", "compressed"])
def test_dp_step_at_world_size_1_equals_train_step_on_card(cuda, kind):
    """The §6 trainer on a one-rank mesh on the card: two steps give
    make_train_step's losses and parameters to the bit.  A narrow fp32
    audio encoder at head dim 32 (the fma attention kernels both ways; no
    embedding, whose gradient is an atomic scatter on the card)."""
    from repro_torch.core.device_order import topoopt_mesh
    from repro_torch.parallel.compression import Compressor
    from repro_torch.train.steps import init_compressor_residual, make_shardmap_dp_train_step

    cfg = dataclasses.replace(get_config("hubert-xlarge").smoke(), head_dim=32, n_heads=4,
                              n_kv_heads=4, param_dtype="float32", activation_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    batches = [{"frames": torch.randn(2, 77, cfg.d_model, generator=gen).to(cuda),
                "labels": torch.randint(0, cfg.vocab, (2, 77), generator=gen).to(cuda)}
               for _ in range(2)]

    def run(dp):
        model = lm.init(0, cfg, device=cuda)
        opt = optim.adamw(optim.constant(1e-3))
        state = opt.init(dict(model.named_parameters()))
        comp = Compressor() if kind == "compressed" else None
        step = (make_shardmap_dp_train_step(cfg, opt, topoopt_mesh((1,), ("data",)),
                                            compressor=comp,
                                            schedule="ring" if comp else kind)
                if dp else make_train_step(cfg, opt))
        residual = init_compressor_residual(comp, model) if comp else None
        losses = []
        for i, batch in enumerate(batches):
            if dp:
                _, _, loss, residual = step(model, state, batch, i, residual)
            else:
                loss = step(model, state, batch, i)[2]["loss"]
            losses.append(loss)
        return losses, dict(model.named_parameters())

    (want_l, want_p), (got_l, got_p) = run(False), run(True)
    assert all(torch.equal(a, b) for a, b in zip(got_l, want_l))
    assert all(torch.equal(got_p[n], want_p[n]) for n in want_p)


def test_jit_train_step_at_world_size_1_equals_train_step_on_card(cuda):
    """The GSPMD trainer under fsdp on a one-rank (1, 1) mesh on the card (a
    one-rank NCCL group): two steps give make_train_step's metrics and
    parameters to the bit.  A narrow fp32 granite-8b (head dim 64: the
    attention kernels both ways); deterministic algorithms, so the
    embedding's gradient is summed in one order in both runs."""
    import torch.distributed as dist

    from repro_torch.core.device_order import Mesh
    from repro_torch.parallel.sharding import ShardingPlan, parameters, placer
    from repro_torch.train.steps import init_opt_state, jit_train_step

    cfg = dataclasses.replace(
        get_config("granite-8b").smoke(), d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, param_dtype="float32", activation_dtype="float32",
    )
    gen = torch.Generator().manual_seed(0)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (4, 96), generator=gen).to(cuda)}
               for _ in range(2)]
    opt = optim.adamw(optim.constant(1e-3))
    assert not dist.is_initialized()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model = lm.init(0, cfg, device=cuda)
        state = opt.init(dict(model.named_parameters()))
        plain = make_train_step(cfg, opt)
        want = [plain(model, state, b, i)[2] for i, b in enumerate(batches)]
        mesh = Mesh(np.zeros((1, 1), dtype=np.int64), ("data", "model"))
        step, (_, _, p_layouts, o_layouts, _) = jit_train_step(cfg, opt, ShardingPlan(fsdp=True),
                                                               mesh, device=cuda)
        placed = lm.init(0, cfg, device=cuda, place=placer(p_layouts))
        placed_state = init_opt_state(opt, placed, o_layouts)
        before = ops.attention_launches, ops.attention_bwd_launches
        got = [step(placed, placed_state, b, i)[2] for i, b in enumerate(batches)]
        assert (ops.attention_launches - before[0], ops.attention_bwd_launches - before[1]) == (
            2 * 2 * cfg.n_layers, 2 * cfg.n_layers)  # forward and remat; backward
        assert all(torch.equal(g[k], w[k]) for g, w in zip(got, want) for k in w)
        params = parameters(placed)
        assert all(torch.equal(params[n].full_tensor(), p) for n, p in model.named_parameters())
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b"])
def test_jit_serve_step_at_world_size_1_equals_make_serve_step_on_card(cuda, arch):
    """Serving under a one-rank (1, 1) mesh on the card (a one-rank NCCL
    group): prefill, padded as serving pads it, and 4 greedy decode steps of
    ``jit_serve_step`` give ``make_serve_step``'s logits and caches to the
    bit.  A narrow fp32 granite-8b and qwen3-moe-30b-a3b (head dim 64: the
    attention kernel in the prefill; the MoE's grouped matmuls in both)."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.device_order import Mesh
    from repro_torch.parallel.sharding import ShardingPlan, placer
    from repro_torch.train.steps import jit_serve_step, make_serve_step

    over = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                param_dtype="float32", activation_dtype="float32")
    if arch == "qwen3-moe-30b-a3b":
        over.update(n_experts=8, top_k=2, d_ff=128, capacity_factor=1.0)
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    S, steps = 96, 4
    tokens = torch.randint(0, cfg.vocab, (4, S), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens.to(cuda)}
    assert not dist.is_initialized()
    try:
        model = lm.init(0, cfg, device=cuda)
        want, want_cache = lm.prefill(model, batch, cfg, pad_to=S + steps)
        mesh = Mesh(np.zeros((1, 1), dtype=np.int64), ("data", "model"))
        plan = ShardingPlan(fsdp=True)
        prefill, (_, p_layouts, _) = jit_serve_step(
            cfg, ShapeSpec("p", S, 4, "prefill"), plan, mesh, device=cuda, pad_to=S + steps)
        decode_shape = ShapeSpec("d", S + steps, 4, "decode")
        decode, _ = jit_serve_step(cfg, decode_shape, plan, mesh, device=cuda)
        plain = make_serve_step(cfg, decode_shape)
        placed = lm.init(0, cfg, device=cuda, place=placer(p_layouts))
        before = ops.attention_launches, ops.grouped_matmul_launches
        got, cache = prefill(placed, batch)
        moe = 3 * cfg.n_layers if cfg.family == "moe" else 0
        assert (ops.attention_launches - before[0],
                ops.grouped_matmul_launches - before[1]) == (cfg.n_layers, moe)
        assert torch.equal(got, want)
        assert all(torch.equal(cache[n].full_tensor(), w) for n, w in want_cache.items())
        tok = want.argmax(-1)
        for i in range(steps):
            want, want_cache = plain(model, {"token": tok, "pos": S + i, "cache": want_cache})
            got, cache = decode(placed, {"token": tok, "pos": S + i, "cache": cache})
            assert torch.equal(got, want)
            assert all(torch.equal(cache[n].full_tensor(), w) for n, w in want_cache.items())
            tok = want.argmax(-1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# One model rank's share on the production mesh's model axis of 16
# (``train.steps.jit_train_step``'s split compute): qwen3-moe-30b-a3b's
# attention (2 query heads over its 1 KV head) and 8 of its 128 experts,
# falcon-mamba-7b's 512 of 8192 channels, recurrentgemma-9b's 256 of 4096
# RG-LRU channels and its attention (1 query head, 1 KV head, window 2048),
# each at its training batch and length.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,KV,S,D,window", [(4, 2, 1, 4096, 128, 0),
                                               (1, 1, 1, 4096, 256, 2048)])
def test_attention_at_a_model_ranks_training_shape(cuda, B, H, KV, S, D, window):
    """Forward and backward (wgmma, bf16) against the plain version and
    autograd of it (fp32), within the bf16 bar."""
    q, k, v = _qkv(cuda, B, H, KV, S, S, D, torch.bfloat16, seed=11)
    do = torch.randn_like(q)
    lse = torch.empty(B, H, S, device=cuda)
    o = flash_attention(q, k, v, causal=True, window=window, lse=lse)
    got = flash_attention_bwd(q, k, v, o, lse, do, True, window, tiling="wgmma")
    torch.cuda.synchronize()
    ref = ref_flash_attention(q, k, v, causal=True, window=window)
    assert float((o.float() - ref.float()).abs().max()) <= TOL[torch.bfloat16]
    for g, want in zip(got, _plain_grads(q, k, v, do, True, window)):
        err = float((g.float() - want).abs().max())
        assert err <= TOL[torch.bfloat16] * float(want.abs().max()), err


@pytest.mark.parametrize("D,F", [(2048, 768), (768, 2048)])
def test_gmm_at_a_model_ranks_training_shape(cuda, D, F):
    """8 experts at qwen3-moe-30b-a3b's training capacity (C = 1280), gate/up
    and down: the forward and the backward against their plain versions."""
    x, w, dy = _xwdy(cuda, 8, 1280, D, F, torch.bfloat16)
    out = moe_gmm(x, w)
    dx, dw = moe_gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_moe_gmm(x, w).float(), rtol=tol, atol=tol)
    rx, rw = ref_moe_gmm_bwd(x, w, dy)
    torch.testing.assert_close(dx.float(), rx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dw.float(), rw.float(), rtol=tol, atol=tol)


def test_mamba_scan_at_a_model_ranks_training_shape(cuda):
    """512 channels at falcon-mamba-7b's training batch and length, b and c
    strided: the forward (and its checkpoints) and the backward against
    their plain versions."""
    args = _mamba_inputs(cuda, 4, 4096, 512, 16, torch.bfloat16, R=256)
    y, h, ckpt = mamba_scan(*args, checkpoints=True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(4, 4096, 512, generator=gen, device=cuda)
    got = mamba_scan_bwd(*args, dy, None, ckpt)
    torch.cuda.synchronize()
    ey, eh = ref_mamba_scan(*args)
    assert float((y - ey).abs().max()) <= 2e-2
    _assert_mamba_bwd_close(got, ref_mamba_scan_bwd(*args, dy, None), torch.bfloat16)


def test_rglru_scan_at_a_model_ranks_training_shape(cuda):
    """256 channels at recurrentgemma-9b's training shape (B = 1, L = 4096,
    fp32 as the layer passes them): the forward and the backward against
    their plain versions."""
    a, h_all, dh, dhf = _lru_bwd_inputs(cuda, 1, 4096, 256, torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(0)
    b = torch.randn(1, 4096, 256, generator=gen, device=cuda)
    h, f = rglru_scan(a, b)
    got = rglru_scan_bwd(a, h_all, dh, dhf)
    torch.cuda.synchronize()
    eh, ef = ref_rglru_scan(a, b)
    torch.testing.assert_close(h, eh, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, ref_rglru_scan_bwd(a, h_all, dh, dhf)):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_jit_train_step_at_world_size_1_equals_train_step_on_card_for_the_moe(cuda):
    """The GSPMD trainer on a narrow fp32 qwen3-moe-30b-a3b (head dim 64, 8
    experts, top 2, capacity 1.0, so entries drop) on a one-rank (1, 1) mesh
    on the card: two steps give make_train_step's metrics and parameters to
    the bit, under deterministic algorithms (the embedding's gradient)."""
    import torch.distributed as dist

    from repro_torch.core.device_order import Mesh
    from repro_torch.parallel.sharding import ShardingPlan, parameters, placer
    from repro_torch.train.steps import init_opt_state, jit_train_step

    cfg = dataclasses.replace(
        get_config("qwen3-moe-30b-a3b").smoke(), d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, n_experts=8, top_k=2, d_ff=128, capacity_factor=1.0,
        param_dtype="float32", activation_dtype="float32",
    )
    gen = torch.Generator().manual_seed(0)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (4, 96), generator=gen).to(cuda)}
               for _ in range(2)]
    opt = optim.adamw(optim.constant(1e-3))
    assert not dist.is_initialized()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model = lm.init(0, cfg, device=cuda)
        state = opt.init(dict(model.named_parameters()))
        plain = make_train_step(cfg, opt)
        want = [plain(model, state, b, i)[2] for i, b in enumerate(batches)]
        mesh = Mesh(np.zeros((1, 1), dtype=np.int64), ("data", "model"))
        step, (_, _, p_layouts, o_layouts, _) = jit_train_step(cfg, opt, ShardingPlan(fsdp=True),
                                                               mesh, device=cuda)
        placed = lm.init(0, cfg, device=cuda, place=placer(p_layouts))
        placed_state = init_opt_state(opt, placed, o_layouts)
        before = ops.grouped_matmul_launches, ops.grouped_matmul_bwd_launches
        got = [step(placed, placed_state, b, i)[2] for i, b in enumerate(batches)]
        assert (ops.grouped_matmul_launches - before[0],
                ops.grouped_matmul_bwd_launches - before[1]) == (
            2 * 6 * cfg.n_layers, 2 * 3 * cfg.n_layers)  # forward and remat; backward
        assert all(torch.equal(g[k], w[k]) for g, w in zip(got, want) for k in w)
        params = parameters(placed)
        assert all(torch.equal(params[n].full_tensor(), p) for n, p in model.named_parameters())
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Every head dim from 1 to 256: the kernels compute at a width of their own
# (attn_mod.compute_width) with zeros past the head dim, store only D columns
# ---------------------------------------------------------------------------

# (B, H, KV, Sq, Sk, causal, window): causal GQA off the tiles' edges, a
# window, cross-attention either way round.
DIM_SHAPES = [
    (2, 4, 2, 130, 130, True, 0),
    (1, 4, 1, 257, 257, True, 64),
    (1, 4, 4, 100, 300, False, 0),
    (1, 4, 2, 127, 65, True, 0),
]
# wgmma: multiples of 8 at each width (64: 8-64, 80: 72, 128: 88-120, 256:
# 136-248); fma: any head dim, ragged at each of its widths.
WGMMA_DIMS = [8, 16, 24, 32, 48, 72, 96, 112, 136, 192, 200, 248]
FMA_DIMS = [1, 7, 16, 24, 33, 48, 72, 96, 100, 112, 129, 192, 200, 255]
DIM_CASES = ([("wgmma", dt, D) for dt in (torch.bfloat16, torch.float16) for D in WGMMA_DIMS]
             + [("fma", dt, D) for dt in (torch.float32, torch.bfloat16) for D in FMA_DIMS])


@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,window", DIM_SHAPES)
@pytest.mark.parametrize("tiling,dtype,D", DIM_CASES)
def test_every_head_dim_matches_plain_both_ways(cuda, tiling, dtype, D, B, H, KV, Sq, Sk, causal,
                                                window):
    """The forward and its lse within the bar of the plain version, the
    backward within the bar of autograd of the plain version, at head dims
    the kernels compute at a wider width, and two launches of each the same
    bits."""
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, D, dtype, seed=21)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(22),
                     device=cuda).to(dtype)
    lse = torch.empty(B, H, Sq, device=cuda)
    o = flash_attention(q, k, v, causal=causal, window=window, tiling=tiling, lse=lse)
    o2 = flash_attention(q, k, v, causal=causal, window=window, tiling=tiling)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling=tiling)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling=tiling)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ref_flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(o.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(lse, ref_flash_attention_lse(q, k, v, causal=causal, window=window),
                               rtol=1e-5, atol=1e-4)
    for g, want, t in zip(got, _plain_grads(q, k, v, do, causal, window), (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        err = float((g.float() - want).abs().max())
        assert err <= TOL[dtype] * max(float(want.abs().max()), 1.0), err


def test_every_head_dim_leaves_the_bytes_past_its_outputs_alone(cuda):
    """Kernels computing D = 40 at a wider width store D columns a row and
    nothing past their outputs: each output carved from a buffer of
    sentinels (the C entry points called directly) leaves the sentinels
    around it as they were, forward and backward, on both tilings."""
    for tiling, dtype in (("wgmma", torch.bfloat16), ("fma", torch.float32)):
        B, H, KV, S, D = 1, 4, 2, 130, 40
        q, k, v = _qkv(cuda, B, H, KV, S, S, D, dtype, seed=23)
        lse = torch.empty(B, H, S, device=cuda)
        o = flash_attention(q, k, v, lse=lse, tiling=tiling)
        n_q, n_k = q.numel(), k.numel()
        buf = torch.full((2 * n_q + 2 * n_k + 4 * 64,), 7.0, device=cuda, dtype=dtype)
        at = [64, n_q + 128, n_q + n_k + 192]  # dq (and the forward's o), dk, dv
        stream = torch.cuda.current_stream().cuda_stream
        code = attn_mod.DTYPE_CODES[dtype]
        err = attn_mod._entry(tiling)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      buf[at[0]:].data_ptr(), None, B, H, KV, S, S, D, 1, 0,
                                      code, stream)
        assert err == 0
        torch.testing.assert_close(buf[at[0]:at[0] + n_q].view(q.shape), o, rtol=0, atol=0)
        keep = torch.ones_like(buf, dtype=torch.bool)
        keep[at[0]:at[0] + n_q] = False
        assert bool((buf[keep] == 7).all())
        buf.fill_(7.0)
        fn, ws = attn_mod._bwd_entries(tiling)
        sms = attn_mod.sms_of(q.device)
        nbytes = ws(B, H, KV, S, S, D, sms) if tiling == "wgmma" else 0
        work = torch.empty(max(nbytes // 4, 1), device=cuda)
        delta = torch.empty(B, H, S, device=cuda)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q.data_ptr(),
                 lse.data_ptr(), buf[at[0]:].data_ptr(), buf[at[1]:].data_ptr(),
                 buf[at[2]:].data_ptr(), delta.data_ptr(), work.data_ptr(), B, H, KV, S, S, D,
                 1, 0, sms, code, stream)
        assert err == 0
        want = flash_attention_bwd(q, k, v, o, lse, q, tiling=tiling)
        keep.fill_(True)
        for start, g in zip(at, want):
            torch.testing.assert_close(buf[start:start + g.numel()].view(g.shape), g, rtol=0,
                                       atol=0)
            keep[start:start + g.numel()] = False
        assert bool((buf[keep] == 7).all())


@pytest.mark.parametrize("D,dtype,want", [(16, torch.bfloat16, "wgmma"), (16, torch.float32, "fma"),
                                          (36, torch.bfloat16, "fma"), (200, torch.float16, "wgmma"),
                                          (255, torch.float32, "fma")])
def test_ops_counts_every_head_dim_under_its_tiling(cuda, monkeypatch, D, dtype, want):
    """``ops.attention`` on a card tensor at any head dim up to 256 launches
    a kernel, forward and, under grad, backward, counted under the tiling
    that served it; bf16 rows TMA cannot stride go to fma by design."""
    for name in BWD_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    q, k, v = (t.requires_grad_(True) for t in _qkv(cuda, 1, 4, 2, 100, 100, D, dtype, seed=24))
    out = ops.attention(q, k, v)
    torch.autograd.grad(out, (q, k, v), torch.randn_like(out))
    other = "fma" if want == "wgmma" else "wgmma"
    assert {n: getattr(ops, n) for n in BWD_COUNTERS} == {
        "attention_launches": 1, f"attention_{want}_launches": 1,
        f"attention_{other}_launches": 0, "attention_bwd_launches": 1,
        f"attention_bwd_{want}_launches": 1, f"attention_bwd_{other}_launches": 0}


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
                                  "llama-3.2-vision-11b", "hubert-xlarge"])
def test_smoke_configs_forward_on_card_matches_cpu(cuda, arch):
    """The JAX package's reduced configs at their own head dim 16 in bf16:
    the forward on the card (wgmma at width 64) within the dense bar, 3e-2
    of max|ref|, of the same weights on the CPU.  The MoE layer by layer on
    the CPU's stream: its bf16 stream parts by an ulp where wgmma rounds P,
    and that flips a near-tied top-2 choice, so each block's router logits
    are held to the bar on every token and its output on the tokens whose
    experts agree."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = get_config(arch).smoke()
    assert cfg.hd == 16
    m_cpu = lm.init(0, cfg, device="cpu")
    m_gpu = lm.init(0, cfg, device=cuda)
    m_gpu.load_state_dict(m_cpu.state_dict())
    rng = np.random.default_rng(0)
    if cfg.family == "moe":
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
        pos = torch.arange(40)[None, :]
        x = T._embed(m_cpu, cfg, tok)

        def router_logits(blk, x, p):
            att = L.attention(blk.attn, L.rms_norm(x, blk.attn.norm), cfg, causal=True,
                              window=cfg.attn_window, positions=p, use_rope=True)[0]
            h = L.rms_norm(x + att, blk.moe.norm)
            return (h.float() @ blk.moe.router).reshape(-1, cfg.n_experts).cpu()

        for blk_cpu, blk_gpu in zip(m_cpu.blocks, m_gpu.blocks):
            lc = router_logits(blk_cpu, x, pos)
            lg = router_logits(blk_gpu, x.to(cuda), pos.to(cuda))
            k = cfg.top_k
            same = (lc.topk(k).indices.sort().values == lg.topk(k).indices.sort().values).all(-1)
            assert float((lg - lc).abs().max()) <= 3e-2 * float(lc.abs().max())
            ref = T._self_block_apply(blk_cpu, x, cfg, pos)[0].float()
            got = T._self_block_apply(blk_gpu, x.to(cuda), cfg, pos.to(cuda))[0].float().cpu()
            rows = same.reshape(ref.shape[:2])
            assert float((got - ref)[rows].abs().max()) <= 3e-2 * float(ref[rows].abs().max())
            x = ref.to(x.dtype)
        ref = (L.rms_norm(x[:, -1], m_cpu.final_norm) @ m_cpu.head()).float()
        got = L.rms_norm(x[:, -1].to(cuda), m_gpu.final_norm) @ m_gpu.head()
        assert float((got.float().cpu() - ref).abs().max()) <= 3e-2 * float(ref.abs().max())
        return
    if cfg.is_encoder:
        batch = {"frames": torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model))).to(
            torch_dtype(cfg.activation_dtype))}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))}
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.img_tokens, cfg.d_model))).to(torch_dtype(cfg.activation_dtype))
    ref, _ = lm.forward(m_cpu, batch, cfg)
    got, _ = lm.forward(m_gpu, {n: t.to(cuda) for n, t in batch.items()}, cfg)
    ref = ref.float()
    assert float((got.float().cpu() - ref).abs().max()) <= 3e-2 * float(ref.abs().max())
