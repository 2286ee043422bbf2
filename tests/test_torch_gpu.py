"""The CUDA flash-attention kernel against its plain version, on the card.

Run on a machine with a CUDA card: ``python -m pytest -m gpu tests/test_torch_gpu.py``.
Every test here skips without one (decided in the fixture, never at import).
"""

import dataclasses

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import ref_flash_attention
from repro_torch.models import lm

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
