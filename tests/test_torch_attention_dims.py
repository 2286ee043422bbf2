"""Attention at every head dim the JAX package takes (1 to 256): the tiling
rule, the plain version against the JAX oracle, its Pallas kernel
(interpret mode) and the models' XLA attention at head dims no served model
has, the plain forward, lse and backward against ``jax.grad``,
and the JAX package's smoke configs at their own head dim 16 through
``models.lm``, port against JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.models import lm as jlm
from repro.models.layers import _sdpa, causal_mask
from repro_torch.configs import base as tbase
from repro_torch.kernels.flash_attention import (
    DTYPE_CODES, FMA_RAGGED_WIDTHS, FMA_WIDTHS, HALF_DTYPES, MAX_HEAD_DIM, WGMMA_WIDTHS,
    _tiling, attention_bwd_tiling, attention_tiling, compute_width,
)
from repro_torch.kernels.ref import (
    ref_flash_attention, ref_flash_attention_bwd, ref_flash_attention_lse,
)
from repro_torch.models import lm
from repro_torch.weights import params_from_jax

torch.set_num_threads(2)  # several test processes share the cores

TILING_FNS = {"forward": attention_tiling, "backward": attention_bwd_tiling}
# Head dims no served model has, around and across the kernels' widths.
NEW_DIMS = [8, 16, 24, 40, 96, 112, 192, 200]
# (B, H, KV, Sq, Sk, causal, window): causal GQA off the 64-row tiles, a
# sliding window, and cross-attention (Sq the prompt, Sk the image).
CASES = {
    "causal": (1, 4, 2, 70, 70, True, 0),
    "window": (1, 4, 2, 70, 70, True, 16),
    "cross": (1, 4, 2, 40, 101, False, 0),
}


def _tol(dtype):
    # test_kernels.py's bars: fp16 rounds the output, fp32 only reorders sums.
    return dict(rtol=2e-2, atol=2e-2) if dtype != np.float32 else dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, B, H, KV, Sq, Sk, D, dtype):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(dtype),
            rng.standard_normal((B, KV, Sk, D)).astype(dtype),
            rng.standard_normal((B, KV, Sk, D)).astype(dtype))


def _xla_attention(q, k, v, causal, window):
    """The JAX models' attention (``layers._sdpa``, its mask from
    ``causal_mask``; none across) in the port's (B, H, S, D) layout."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = jnp.asarray(q.reshape(B, KV, H // KV, Sq, D).transpose(0, 3, 1, 2, 4))
    kt, vt = (jnp.asarray(t.transpose(0, 2, 1, 3)) for t in (k, v))
    mask = causal_mask(Sq, Sk, window=window) if causal else None
    out = np.asarray(_sdpa(qg, kt, vt, mask), np.float32)  # (B, Sq, KV, G, D)
    return out.transpose(0, 2, 3, 1, 4).reshape(B, H, Sq, D)


@pytest.mark.parametrize("dtype", list(DTYPE_CODES))
@pytest.mark.parametrize("which", list(TILING_FNS))
def test_every_head_dim_gets_a_tiling(which, dtype):
    """Every head dim 1..256 gets a tiling, forward and backward alike:
    wgmma for bf16/fp16 rows of whole 16-byte chunks (D % 8 == 0, TMA's
    rule), fma for the rest, each at a width its kernels are built for."""
    for D in range(1, MAX_HEAD_DIM + 1):
        tiling = TILING_FNS[which](dtype, D)
        want = "wgmma" if dtype in HALF_DTYPES and D % 8 == 0 else "fma"
        assert tiling == want, (D, tiling)
        width = compute_width(tiling, D)
        assert width >= D and width in (WGMMA_WIDTHS if tiling == "wgmma" else
                                        FMA_WIDTHS + FMA_RAGGED_WIDTHS), (D, width)


@pytest.mark.parametrize("D,width", [(1, 32), (16, 32), (31, 32), (32, 32), (33, 64), (64, 64),
                                     (72, 128), (80, 80), (81, 128), (128, 128), (129, 256),
                                     (255, 256), (256, 256)])
def test_fma_width(D, width):
    """fma: the head dims with instances of their own run at their width,
    the rest at the next ragged width (``csrc/flash_attention.cu``'s and
    ``flash_attention_bwd.cu``'s ``launch_d``)."""
    assert compute_width("fma", D) == width


@pytest.mark.parametrize("D,width", [(8, 64), (16, 64), (64, 64), (72, 80), (80, 80), (88, 128),
                                     (128, 128), (136, 256), (200, 256), (256, 256)])
def test_wgmma_width(D, width):
    """wgmma: the next of the widths 64, 80, 128 and 256 (``launch_wgmma_d``)."""
    assert compute_width("wgmma", D) == width


@pytest.mark.parametrize("D", [0, MAX_HEAD_DIM + 1, 512])
@pytest.mark.parametrize("dtype", list(DTYPE_CODES))
@pytest.mark.parametrize("which", list(TILING_FNS))
def test_head_dims_past_the_limit_raise(which, dtype, D):
    with pytest.raises(ValueError, match=f"head dim {D} outside 1..{MAX_HEAD_DIM}"):
        TILING_FNS[which](dtype, D)


@pytest.mark.parametrize("D", [4, 36, 100, 250])
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_wgmma_refuses_rows_tma_cannot_stride(name, D):
    """Asked for wgmma at a head dim off a multiple of 8, the tiling check
    the wrappers make raises and says why."""
    with pytest.raises(ValueError, match="multiple of 8"):
        _tiling(name, torch.bfloat16, D, "wgmma")


@pytest.mark.parametrize("target", ["jax_ref", "pallas_interpret", "xla"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_attention_matches_jax_at_new_head_dims(dtype, D, case, target):
    B, H, KV, Sq, Sk, causal, window = CASES[case]
    q, k, v = _qkv(D, B, H, KV, Sq, Sk, D, dtype)
    if target == "jax_ref":
        expect = jref.ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, window=window)
    elif target == "pallas_interpret":
        expect = pallas_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal, window=window, interpret=True)
    else:
        expect = _xla_attention(q, k, v, causal, window)
    out = ref_flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, window=window)
    assert out.shape == (B, H, Sq, D)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expect, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_grads_match_jax_grad(dtype, D, case):
    """The kernels' plain versions, the oracle the card's kernels are held
    to: ``ref_flash_attention`` with ``ref_flash_attention_lse``, then
    ``ref_flash_attention_bwd`` from that lse: the output and dq, dk, dv
    against the JAX oracle and ``jax.grad`` of it on the same values, fp32
    at 1e-5, bf16 inputs within 2e-2 of the largest gradient (the port
    rounds each gradient once)."""
    B, H, KV, Sq, Sk, causal, window = CASES[case]
    qn, kn, vn = _qkv(100 + D, B, H, KV, Sq, Sk, D, np.float32)
    don = np.random.default_rng(200 + D).standard_normal((B, H, Sq, D)).astype(np.float32)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in (qn, kn, vn, don))
    out = ref_flash_attention(q, k, v, causal=causal, window=window)
    lse = ref_flash_attention_lse(q, k, v, causal, window)
    got = ref_flash_attention_bwd(q, k, v, out, lse, do, causal, window)

    def jax_out(a, b, c):
        return jref.ref_flash_attention(a, b, c, causal=causal, window=window)

    as_jax = [jnp.asarray(t.float().numpy()) for t in (q, k, v, do)]
    expect = jax_out(*as_jax[:3])
    want = jax.grad(lambda a, b, c: jnp.sum(jax_out(a, b, c) * as_jax[3]),
                    argnums=(0, 1, 2))(*as_jax[:3])
    bar = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expect),
                               rtol=bar, atol=bar)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        w = np.asarray(w)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= bar * max(float(np.abs(w).max()), 1.0), err


SMOKE_ARCHS = ["granite-8b", "qwen3-moe-30b-a3b", "recurrentgemma-9b", "llama-3.2-vision-11b",
               "hubert-xlarge"]


# Every arch in fp32; in bf16 end to end only those whose two packages round
# at the same places.  The MoE's bf16 streams part by an ulp after the first
# attention and then flip a near-tied top-2 choice, and XLA fuses the RG-LRU's
# elementwise chains that PyTorch rounds step by step, so over 30 tokens
# recurrentgemma-9b's bf16 logits part by 3.6% of their largest (0.125 of
# 3.45), past the dense bar: test_torch_model.py holds both in bf16 its own
# way (the MoE layer by layer, the recurrent prefill over 24 tokens).
BF16_ARCHS = ["granite-8b", "llama-3.2-vision-11b", "hubert-xlarge"]
SMOKE_CASES = ([(arch, "float32") for arch in SMOKE_ARCHS]
               + [(arch, "bfloat16") for arch in BF16_ARCHS])


@pytest.mark.parametrize("arch,dtype", SMOKE_CASES)
def test_smoke_configs_at_their_head_dim_match_jax(arch, dtype):
    """The JAX package's reduced configs, unchanged but for their dtype, at
    head dim 16 (the card runs them on wgmma at width 64): the port's
    forward against the JAX model's on the same weights and inputs (a VLM's
    cross gates at 0.5), fp32 at test_models_smoke.py's 2e-4, bf16 at the
    dense bar, 3e-2 of max|ref|."""
    over = dict(param_dtype=dtype, activation_dtype=dtype)
    jcfg = dataclasses.replace(jbase.get_config(arch).smoke(), **over)
    tcfg = dataclasses.replace(tbase.get_config(arch).smoke(), **over)
    assert tcfg.hd == jcfg.hd == 16
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    if jcfg.family == "vlm":  # tanh(0) = 0 would throw the cross-attention away
        blocks = dict(jparams["blocks"])
        cross, attn = dict(blocks["cross"]), dict(blocks["cross"]["attn"])
        attn["gate"] = jnp.full_like(attn["gate"], 0.5)
        cross["attn"] = attn
        blocks["cross"] = cross
        jparams = {**jparams, "blocks": blocks}
    model = lm.init(0, tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    rng = np.random.default_rng(7)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    if tcfg.is_encoder:
        arrays = {"frames": rng.standard_normal((2, 30, tcfg.d_model)).astype(np.float32)}
    else:
        arrays = {"tokens": rng.integers(0, tcfg.vocab, (2, 30)).astype(np.int32)}
        if tcfg.family == "vlm":
            arrays["image_embeds"] = rng.standard_normal(
                (2, tcfg.img_tokens, tcfg.d_model)).astype(np.float32)
    jbatch = {n: jnp.asarray(a) if a.dtype.kind == "i" else jnp.asarray(a, jdt)
              for n, a in arrays.items()}
    tbatch = {n: torch.from_numpy(a) if a.dtype.kind == "i" else torch.from_numpy(a).to(tdt)
              for n, a in arrays.items()}
    expect, _ = jlm.forward(jparams, jbatch, jcfg, remat="none")
    got, _ = lm.forward(model, tbatch, tcfg)
    expect = np.asarray(expect.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.float().numpy(), expect, rtol=2e-4, atol=2e-4)
    else:
        assert np.abs(got.float().numpy() - expect).max() <= 3e-2 * np.abs(expect).max()
