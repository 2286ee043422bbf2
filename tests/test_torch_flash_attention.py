"""The port's plain attention against the JAX package's oracle and its Pallas
kernel (interpret mode), on the shapes and tolerances of test_kernels.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.models.layers import _sdpa, causal_mask
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import (
    TILINGS, attention_bwd_tiling, attention_tiling, check_bwd, first_masked_row,
    flash_attention, flash_attention_bwd,
)
from repro_torch.launch.trace_train import group_of
from repro_torch.kernels.ref import (
    attention_mask, ref_flash_attention, ref_flash_attention_bwd, ref_flash_attention_lse,
)

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
        (torch.float32, 32, "fma"),  # examples/train_lm_topoopt.py's fp32 model
        (torch.bfloat16, 32, "wgmma"),  # computed at width 64, TMA's zeros past 32
        (torch.bfloat16, 16, "wgmma"),  # the smoke configs' head dim
        (torch.float32, 72, "fma"),     # a ragged instance at width 128
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


# ---------------------------------------------------------------------------
# Training: the backward kernel's plain version and the forward's lse
# ---------------------------------------------------------------------------

BWD_SHAPES = [  # (B, H, KV, Sq, Sk, D, causal, window)
    (2, 4, 4, 64, 64, 64, True, 0),     # MHA, causal
    (1, 8, 2, 70, 70, 128, True, 0),    # GQA 4:1, ragged
    (2, 4, 1, 48, 48, 64, True, 16),    # MQA, sliding window
    (1, 4, 4, 40, 40, 64, False, 0),    # bidirectional
    (1, 4, 2, 30, 90, 64, False, 0),    # Sq < Sk
    (1, 4, 2, 90, 30, 64, True, 0),     # causal, Sq > Sk
    (1, 2, 2, 50, 50, 32, False, 8),    # window, not causal
    (1, 4, 1, 40, 40, 256, True, 0),    # recurrentgemma-9b's head dim, MQA
    (1, 4, 1, 70, 70, 256, True, 24),   # and its sliding window, S past it
    (1, 4, 4, 70, 70, 80, False, 0),    # hubert-xlarge's head dim, bidirectional MHA
    (1, 4, 2, 77, 77, 80, True, 0),     # causal GQA at D = 80, ragged
    (1, 4, 4, 50, 90, 80, False, 0),    # D = 80, Sq != Sk
]
BWD_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32: the same math, sums in another order


def _bwd_inputs(seed, B, H, KV, Sq, Sk, D):
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed, B, H, KV, Sq, Sk, D, np.float32))
    do = torch.from_numpy(np.random.default_rng(seed + 100).standard_normal((B, H, Sq, D),
                                                                            dtype=np.float32))
    return q, k, v, do


def _plain_bwd(q, k, v, do, causal, window):
    o = ref_flash_attention(q, k, v, causal=causal, window=window)
    lse = ref_flash_attention_lse(q, k, v, causal=causal, window=window)
    return ref_flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,window", BWD_SHAPES)
def test_plain_bwd_matches_autograd_of_plain_attention(B, H, KV, Sq, Sk, D, causal, window):
    q, k, v, do = _bwd_inputs(7, B, H, KV, Sq, Sk, D)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ref_flash_attention(qg, kg, vg, causal=causal, window=window)
    expect = torch.autograd.grad(out, (qg, kg, vg), do)
    for got, want in zip(_plain_bwd(q, k, v, do, causal, window), expect):
        assert got.shape == want.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, want, **BWD_TOL)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,window", BWD_SHAPES)
def test_plain_bwd_matches_jax_grad_of_reference(B, H, KV, Sq, Sk, D, causal, window):
    q, k, v, do = _bwd_inputs(8, B, H, KV, Sq, Sk, D)
    _, vjp = jax.vjp(
        lambda a, b, c: jref.ref_flash_attention(a, b, c, causal=causal, window=window),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)),
    )
    expect = vjp(jnp.asarray(do.numpy()))
    for got, want in zip(_plain_bwd(q, k, v, do, causal, window), expect):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD_TOL)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,window", BWD_SHAPES)
def test_plain_lse_matches_logsumexp_of_masked_scores(B, H, KV, Sq, Sk, D, causal, window):
    q, k, v, _ = _bwd_inputs(9, B, H, KV, Sq, Sk, D)
    kk = k.repeat_interleave(H // KV, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", q.double(), kk.double()) / math.sqrt(D)
    mask = attention_mask(Sq, Sk, causal, window)
    expect = torch.logsumexp(scores.masked_fill(~mask, -math.inf), dim=-1)
    got = ref_flash_attention_lse(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, H, Sq)
    torch.testing.assert_close(got.double(), expect, rtol=1e-6, atol=1e-6)


def test_plain_bwd_keeps_the_input_dtype():
    q, k, v, do = (t.to(torch.bfloat16) for t in _bwd_inputs(10, 1, 4, 2, 33, 33, 64))
    grads = _plain_bwd(q, k, v, do, True, 0)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


@pytest.mark.parametrize(
    "Sq,Sk,causal,window,D,match",
    [
        (256, 200, True, 16, 64, "see no key"),   # rows 215.. see no key
        (256, 200, False, 16, 128, "see no key"),
        (64, 8, True, 1, 64, "see no key"),
        (128, 128, True, 0, 264, "head dim 264"),  # past MAX_HEAD_DIM
        (256, 200, True, 16, 256, "see no key"),  # recurrentgemma-9b's head dim, rows 215..
    ],
)
def test_backward_refuses_what_it_does_not_take(Sq, Sk, causal, window, D, match):
    q = torch.zeros(1, 2, Sq, D)
    k = torch.zeros(1, 2, Sk, D)
    with pytest.raises(ValueError, match=match):
        check_bwd(q, k, causal, window)


@pytest.mark.parametrize("S,D,causal,window", [(4096, 64, True, 0), (2048, 128, True, 0),
                                               (1000, 64, False, 0), (2048, 128, True, 2048),
                                               (4096, 256, True, 2048), (4096, 80, False, 0)])
def test_backward_takes_the_training_shapes(S, D, causal, window):
    check_bwd(torch.zeros(1, 1, S, D), torch.zeros(1, 1, S, D), causal, window)


def test_backward_wrapper_refuses_cpu_tensors():
    q, k, v, do = _bwd_inputs(11, 1, 2, 2, 8, 8, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bwd(q, k, v, q, lse, do)


BWD_COUNTERS = ("attention_bwd_launches", "attention_bwd_wgmma_launches",
                "attention_bwd_fma_launches")


def test_ops_attention_on_cpu_stays_differentiable(monkeypatch):
    """Under grad on the CPU, ``ops.attention`` is the plain version: autograd
    differentiates it, and no kernel launch is counted, on either tiling."""
    for name in ATTENTION_COUNTERS + BWD_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    q, k, v, do = _bwd_inputs(12, 1, 4, 2, 40, 40, 64)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.attention(qg, kg, vg, causal=True, window=16)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    for g, want in zip(got, _plain_bwd(q, k, v, do, True, 16)):
        torch.testing.assert_close(g, want, **BWD_TOL)
    assert all(getattr(ops, n) == 0 for n in ATTENTION_COUNTERS + BWD_COUNTERS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ops_attention_on_cpu_in_half_counts_no_backward_tiling(monkeypatch, dtype):
    """bf16 would take the wgmma backward on a card; on the CPU autograd
    differentiates the plain version and no backward tiling is counted."""
    for name in ATTENTION_COUNTERS + BWD_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    q, k, v, do = (t.to(dtype) for t in _bwd_inputs(13, 1, 4, 2, 40, 40, 64))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    got = torch.autograd.grad(ops.attention(qg, kg, vg, causal=True, window=0), (qg, kg, vg), do)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(ref_flash_attention(qr, kr, vr, causal=True), (qr, kr, vr), do)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert all(getattr(ops, n) == 0 for n in ATTENTION_COUNTERS + BWD_COUNTERS)


# ---------------------------------------------------------------------------
# The backward's two tilings: the choice, and the wgmma tiling's roundings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,head_dim,want",
    [
        (torch.bfloat16, 64, "wgmma"),   # minicpm-2b's training attention
        (torch.bfloat16, 128, "wgmma"),  # granite-8b/34b, deepseek-coder-33b
        (torch.float16, 64, "wgmma"),
        (torch.float16, 128, "wgmma"),
        (torch.float32, 64, "fma"),      # the narrow fp32 models: exact fp32 products
        (torch.float32, 128, "fma"),
        (torch.bfloat16, 80, "wgmma"),      # hubert-xlarge's training attention
        (torch.float16, 80, "wgmma"),
        (torch.float32, 80, "fma"),         # its narrow fp32 models
        (torch.bfloat16, 96, "wgmma"),      # no model's head dim: width 128
        (torch.bfloat16, 256, "wgmma"),     # recurrentgemma-9b's training attention
        (torch.float32, 256, "fma"),        # its narrow fp32 models
        (torch.float32, 32, "fma"),         # examples/train_lm_topoopt.py's fp32 model
        (torch.float16, 32, "wgmma"),       # width 64
        (torch.float32, 16, "fma"),         # the smoke configs' head dim in fp32
        (torch.int32, 64, ValueError),
    ],
)
def test_attention_bwd_tiling(dtype, head_dim, want):
    if isinstance(want, str):
        assert attention_bwd_tiling(dtype, head_dim) == want
    else:
        with pytest.raises(want):
            attention_bwd_tiling(dtype, head_dim)


@pytest.mark.parametrize("tiling", TILINGS)
def test_backward_wrapper_refuses_cpu_tensors_for_every_tiling(tiling):
    q, k, v, do = (t.to(torch.bfloat16) for t in _bwd_inputs(11, 1, 2, 2, 8, 8, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bwd(q, k, v, q, torch.zeros(1, 2, 8), do, tiling=tiling)


def _wgmma_bwd_emulation(q, k, v, do, causal, window):
    """The wgmma backward tiling's arithmetic on the CPU: q, k, v, do in their
    16-bit dtype, o as the forward stores it (rounded to that dtype), S, dP,
    P and dS in fp32, P and dS rounded to the 16-bit dtype where the kernel
    packs them into wgmma A fragments, the dV, dK and dQ products summed in
    fp32, and the gradients rounded to the dtype."""
    dtype = q.dtype
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    o = ref_flash_attention(q, k, v, causal=causal, window=window)
    lse = ref_flash_attention_lse(q, k, v, causal=causal, window=window)
    qf, of, dof = (t.float().reshape(B, KV, H // KV, Sq, D) for t in (q, o, do))
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgsd,bktd->bkgst", qf, kf) / math.sqrt(D)
    mask = attention_mask(Sq, Sk, causal, window)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, H // KV, Sq, 1)), 0.0)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, vf)
    ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
    p16, ds16 = p.to(dtype).float(), ds.to(dtype).float()
    dv = torch.einsum("bkgst,bkgsd->bktd", p16, dof)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds16, qf) / math.sqrt(D)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds16, kf) / math.sqrt(D)
    return dq.reshape(B, H, Sq, D).to(dtype), dk.to(dtype), dv.to(dtype)


def _jax_grad_of_sdpa(q, k, v, do, causal, window):
    """jax.grad of the JAX model's ``_sdpa`` (fp32, on the same values) in the
    port's layouts: q, do (B, H, Sq, D); k, v (B, KV, Sk, D); unmasked when
    not causal."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    to_q = lambda t: jnp.asarray(t.float().numpy().reshape(B, KV, H // KV, Sq, D)
                                 .transpose(0, 3, 1, 2, 4))
    to_k = lambda t: jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3))
    mask = causal_mask(Sq, Sk, window=window) if causal else None
    dog = to_q(do)
    loss = lambda a, b, c: jnp.sum(_sdpa(a, b, c, mask) * dog)
    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(to_q(q), to_k(k), to_k(v))
    return (np.asarray(dq).transpose(0, 2, 3, 1, 4).reshape(B, H, Sq, D),
            np.asarray(dk).transpose(0, 2, 1, 3), np.asarray(dv).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_bwd_roundings_match_jax_grad_of_sdpa(dtype, D, causal, window):
    """The wgmma tiling rounds P and dS to 16 bits before its dV, dK and dQ
    products (as the JAX model rounds its probabilities to v's dtype); on
    the same inputs its gradients stay within the card's bar, 2e-2 of the
    largest gradient, of jax.grad of the reference attention.  S = 130 puts
    ragged edges in the 64-row tiles, and GQA 2:1 sums dk and dv over two
    heads."""
    q, k, v, do = (t.to(dtype) for t in _bwd_inputs(21, 2, 4, 2, 130, 130, D))
    got = _wgmma_bwd_emulation(q, k, v, do, causal, window)
    want = _jax_grad_of_sdpa(q, k, v, do, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= 2e-2 * float(np.abs(w).max()), (name, err)


def test_wgmma_bwd_emulation_in_fp32_is_the_plain_backward():
    """Without the 16-bit roundings the emulation is the plain backward: the
    rounding is the one thing it adds."""
    q, k, v, do = _bwd_inputs(22, 1, 4, 2, 70, 70, 64)
    for got, want in zip(_wgmma_bwd_emulation(q, k, v, do, True, 16),
                         _plain_bwd(q, k, v, do, True, 16)):
        torch.testing.assert_close(got, want, **BWD_TOL)


@pytest.mark.parametrize(
    "kernel,group",
    [
        ("void (anonymous namespace)::dkdv_wgmma_kernel<__nv_bfloat16, 64>(CUtensorMap_st, "
         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float const*, "
         "__nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int, int, float, float)",
         "attention backward"),
        ("void (anonymous namespace)::dq_wgmma_kernel<__half, 128>(CUtensorMap_st)",
         "attention backward"),
        ("void (anonymous namespace)::dkdv_wgmma_kernel<__nv_bfloat16, 80>(CUtensorMap_st, "
         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float const*, "
         "__nv_bfloat16*, __nv_bfloat16*, float*, int, int, int, int, int, int, int, float, "
         "float)", "attention backward"),
        ("void (anonymous namespace)::dkdv_kernel<float, 80>(float const*)", "attention backward"),
        ("void (anonymous namespace)::dkdv_kernel<float, 64>(float const*)", "attention backward"),
        ("void (anonymous namespace)::dq_kernel<float, 128>(float const*)", "attention backward"),
        ("void (anonymous namespace)::delta_kernel<__nv_bfloat16, 64>(__nv_bfloat16 const*)",
         "attention backward"),
        ("void (anonymous namespace)::flash_attention_wgmma_kernel<__nv_bfloat16, 64>("
         "CUtensorMap_st)", "attention forward"),
        ("void (anonymous namespace)::flash_attention_fwd_kernel<float, 64, 64, 64>(float const*)",
         "attention forward"),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "GEMM"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor>", "other"),
        ("void (anonymous namespace)::mamba_bwd_kernel<__nv_bfloat16, 1>((anonymous "
         "namespace)::Args)", "selective scan backward"),
        ("void (anonymous namespace)::mamba_bwd_reduce_kernel<__nv_bfloat16>(float const*)",
         "selective scan backward"),
        ("void (anonymous namespace)::mamba_scan_kernel<__nv_bfloat16, 1, true>(CUtensorMap_st)",
         "selective scan forward"),
        ("void (anonymous namespace)::dkdv_sum_kernel<__nv_bfloat16>(float const*, "
         "__nv_bfloat16*, __nv_bfloat16*, int, unsigned long, float)", "attention backward"),
        ("void (anonymous namespace)::lru_bwd_kernel<float>((anonymous namespace)::Maps, "
         "float const*, float const*, float const*, float const*, float*, float*, int, int, int)",
         "RG-LRU backward"),
        ("void (anonymous namespace)::lru_bwd_kernel<__nv_bfloat16>((anonymous namespace)::Maps)",
         "RG-LRU backward"),
        ("void (anonymous namespace)::lru_fwd_kernel<float>((anonymous namespace)::Maps, float "
         "const*, float const*, float*, float*, int, int, int)", "RG-LRU forward"),
        ("void (anonymous namespace)::lru_fwd_kernel<__half>((anonymous namespace)::Maps)",
         "RG-LRU forward"),
        # Head dim 80's kernels: the forward, the dk/dv items that also sum dQ
        # in turns, and the cast of dQ's sums.
        ("void (anonymous namespace)::flash_attention_d80_wgmma_kernel<__nv_bfloat16>("
         "CUtensorMap_st)", "attention forward"),
        ("void (anonymous namespace)::dkdv_d80_wgmma_kernel<__nv_bfloat16>(CUtensorMap_st)",
         "attention backward"),
        ("void (anonymous namespace)::dq_d80_cast_kernel<__half>(float const*, __half*, long, int, "
         "int, float)", "attention backward"),
        ("void (anonymous namespace)::dkdv_d80_wgmma_kernel<__half>(CUtensorMap_st, "
         "CUtensorMap_st)", "attention backward"),
        # The head dims computed at a wider width: the fma forward's ragged
        # kernel and the fma backward's ragged instances.
        ("void (anonymous namespace)::flash_attention_fwd_ragged_kernel<__nv_bfloat16, 32, 64, "
         "64>(__nv_bfloat16 const*)", "attention forward"),
        ("void (anonymous namespace)::dkdv_kernel<float, 128, true>(float const*)",
         "attention backward"),
        ("void (anonymous namespace)::dq_kernel<__half, 32, true>(__half const*)",
         "attention backward"),
    ],
)
def test_trace_train_groups_both_backward_tilings(kernel, group):
    assert group_of(kernel) == group
