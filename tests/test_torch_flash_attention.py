"""The port's plain attention against the JAX package's oracle and its Pallas
kernel (interpret mode), on the shapes and tolerances of test_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import ref_flash_attention

torch.set_num_threads(2)  # several test processes share the cores

SHAPES = [
    (2, 4, 4, 256, 64, True, 0),     # MHA causal
    (1, 8, 2, 256, 128, True, 0),    # GQA 4:1
    (2, 4, 1, 384, 64, True, 0),     # MQA
    (2, 4, 4, 256, 64, False, 0),    # bidirectional (encoder)
    (1, 4, 2, 512, 64, True, 128),   # sliding window (griffin)
    (1, 2, 2, 128, 32, True, 0),     # small dims
]


def _tol(dtype):
    # test_kernels.py's bars: fp16 rounds the output, fp32 only reorders sums.
    return dict(rtol=2e-2, atol=2e-2) if dtype != np.float32 else dict(
        rtol=2e-5, atol=2e-5
    )


def _qkv(seed, B, H, KV, Sq, Sk, D, dtype):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, H, Sq, D)).astype(dtype),
        rng.standard_normal((B, KV, Sk, D)).astype(dtype),
        rng.standard_normal((B, KV, Sk, D)).astype(dtype),
    )


def _port(q, k, v, **kw):
    out = ref_flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    return out.float().numpy()


@pytest.mark.parametrize("target", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("B,H,KV,S,D,causal,window", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_attention_matches_jax(B, H, KV, S, D, causal, window, dtype, target):
    q, k, v = _qkv(0, B, H, KV, S, S, D, dtype)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if target == "jax_ref":
        expect = jref.ref_flash_attention(jq, jk, jv, causal=causal, window=window)
    else:
        expect = pallas_flash_attention(
            jq, jk, jv, causal=causal, window=window, interpret=True
        )
    out = _port(q, k, v, causal=causal, window=window)
    assert out.shape == (B, H, S, D)
    np.testing.assert_allclose(out, np.asarray(expect, np.float32), **_tol(dtype))


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 256), (37, 53)])
def test_plain_attention_ragged_length(block_q, block_k):
    """The 222-long sequence: Pallas pads to its blocks, the plain path does not."""
    q, k, v = _qkv(1, 1, 2, 2, 222, 222, 64, np.float32)
    expect = pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=block_q, block_k=block_k, interpret=True,
    )
    np.testing.assert_allclose(
        _port(q, k, v, causal=True), np.asarray(expect), rtol=3e-5, atol=3e-5
    )


def test_ops_attention_on_cpu_runs_plain_version(monkeypatch):
    monkeypatch.setattr(ops, "attention_launches", 0)
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 4, 2, 40, 40, 64, np.float32))
    out = ops.attention(q, k, v, causal=True, window=16)
    torch.testing.assert_close(out, ref_flash_attention(q, k, v, causal=True, window=16),
                               rtol=0, atol=0)
    assert ops.attention_launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on another path: CPU input raises."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 2, 2, 8, 8, 64, np.float32))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, k, v)


def test_build_raises_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
