"""The port's plain attention against the JAX package's oracle and its Pallas
kernel (interpret mode), on the shapes and tolerances of test_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import (
    TILINGS, attention_tiling, first_masked_row, flash_attention,
)
from repro_torch.kernels.ref import attention_mask, ref_flash_attention

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


@pytest.mark.parametrize("target", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D,causal",
    [
        (2, 4, 4, 200, 200, 80, False),  # hubert-xlarge's head dim, bidirectional
        (1, 4, 2, 129, 129, 80, True),   # head dim 80, causal, GQA
        (1, 4, 1, 127, 300, 80, False),  # head dim 80, Sq != Sk
        (1, 8, 2, 40, 101, 128, False),  # cross-attention: Sq the prompt, ragged Sk the image
        (2, 4, 4, 130, 37, 64, False),   # cross-attention, Sk < Sq
    ],
)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_attention_matches_jax_head_dim_80_and_cross(B, H, KV, Sq, Sk, D, causal, dtype,
                                                          target):
    q, k, v = _qkv(4, B, H, KV, Sq, Sk, D, dtype)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if target == "jax_ref":
        expect = jref.ref_flash_attention(jq, jk, jv, causal=causal)
    else:
        expect = pallas_flash_attention(jq, jk, jv, causal=causal, interpret=True)
    out = _port(q, k, v, causal=causal)
    assert out.shape == (B, H, Sq, D)
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


@pytest.mark.parametrize(
    "Sq,Sk,causal,window",
    [
        (256, 200, True, 16),     # rows 215.. see no key
        (256, 200, False, 16),
        (219, 200, True, 16),     # the last four rows
        (214, 200, True, 16),     # one row short of the first masked one: none
        (256, 256, True, 0),      # the served prefills: Sq = Sk
        (1000, 1000, True, 128),
        (2048, 2048, True, 2048),
        (300, 100, True, 0),      # causal, Sq > Sk, no window: key 0 is always seen
        (100, 300, False, 0),
        (64, 8, True, 1),         # a window of one key
        (10, 3, False, 4),
        (5, 1, True, 1),
    ],
)
def test_first_masked_row_matches_the_plain_mask(Sq, Sk, causal, window):
    """The rows the wrapper repairs are exactly those in which the plain
    version's mask keeps no key."""
    seen = attention_mask(Sq, Sk, causal, window).any(dim=1)
    first = first_masked_row(Sq, Sk, causal, window)
    assert 0 <= first <= Sq
    assert bool(seen[:first].all()) and not bool(seen[first:].any())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_attention_gives_fully_masked_rows_the_mean_of_v(causal, dtype):
    """Sq 256, Sk 200, window 16: rows 215.. see no key.  The JAX oracle and
    the plain version give them the mean of v over all Sk keys."""
    B, H, KV, Sq, Sk, D, window = 2, 4, 2, 256, 200, 64, 16
    q, k, v = _qkv(5, B, H, KV, Sq, Sk, D, dtype)
    out = _port(q, k, v, causal=causal, window=window)
    expect = jref.ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, window=window)
    np.testing.assert_allclose(out, np.asarray(expect, np.float32), **_tol(dtype))
    first = first_masked_row(Sq, Sk, causal, window)
    assert first == Sk + window - 1 < Sq
    mean = np.repeat(v.astype(np.float32).mean(axis=2), H // KV, axis=1)  # (B, H, D)
    np.testing.assert_allclose(out[:, :, first:],
                               np.broadcast_to(mean[:, :, None], out[:, :, first:].shape),
                               **_tol(dtype))


ATTENTION_COUNTERS = ("attention_launches", "attention_wgmma_launches", "attention_fma_launches")


def _check_ops_attention_on_cpu(monkeypatch, dtype):
    for name in ATTENTION_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(2, 1, 4, 2, 40, 40, 64, np.float32))
    out = ops.attention(q, k, v, causal=True, window=16)
    torch.testing.assert_close(out, ref_flash_attention(q, k, v, causal=True, window=16),
                               rtol=0, atol=0)
    assert all(getattr(ops, name) == 0 for name in ATTENTION_COUNTERS)


def test_ops_attention_on_cpu_runs_plain_version(monkeypatch):
    _check_ops_attention_on_cpu(monkeypatch, torch.float32)


def test_ops_attention_on_cpu_counts_no_tiling_in_bf16(monkeypatch):
    """bf16 would take the wgmma tiling on a card; on the CPU it is plain."""
    _check_ops_attention_on_cpu(monkeypatch, torch.bfloat16)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on another path: CPU input raises."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 2, 2, 8, 8, 64, np.float32))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, k, v)


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrapper_refuses_cpu_tensors_for_every_tiling(tiling, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(3, 1, 2, 2, 8, 8, 64, np.float32))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, k, v, tiling=tiling)


@pytest.mark.parametrize(
    "dtype,head_dim,want",
    [
        (torch.bfloat16, 128, "wgmma"),  # granite-8b and qwen3-moe-30b-a3b prefill
        (torch.bfloat16, 256, "wgmma"),  # recurrentgemma-9b prefill
        (torch.bfloat16, 64, "wgmma"),
        (torch.float16, 128, "wgmma"),
        (torch.float16, 256, "wgmma"),
        (torch.float32, 64, "fma"),  # the narrow fp32 models
        (torch.float32, 128, "fma"),
        (torch.float32, 256, "fma"),
        (torch.bfloat16, 80, "wgmma"),  # hubert-xlarge's prefill
        (torch.float16, 80, "wgmma"),
        (torch.float32, 80, "fma"),
        (torch.bfloat16, 16, ValueError),  # the smoke configs' head dim: CPU only
        (torch.float32, 72, ValueError),
        (torch.int32, 128, ValueError),
    ],
)
def test_attention_tiling(dtype, head_dim, want):
    if isinstance(want, str):
        assert attention_tiling(dtype, head_dim) == want
    else:
        with pytest.raises(want):
            attention_tiling(dtype, head_dim)


def test_library_name_changes_with_a_header(tmp_path, monkeypatch):
    """A library is named by a hash of its source, the headers beside it and
    the flags, so an edited header is never served from a stale build."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    first = _build.lib_path("k")
    assert _build.lib_path("k") == first
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    second = _build.lib_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build.lib_path("k") not in (first, second)
    (tmp_path / "other.cuh").unlink()
    assert _build.lib_path("k") == second
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n// edited\n')
    assert _build.lib_path("k") not in (first, second)


def test_build_raises_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
