"""The port's granite-8b, qwen3-moe-30b-a3b, falcon-mamba-7b and
recurrentgemma-9b smoke models against the JAX package's, on the same weights
(copied in with ``params_from_jax``) and the same numpy prompts.  The VLM and
audio families are in ``test_torch_vlm_audio.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import transformer as jT
from repro_torch.configs import base as tbase
from repro_torch.launch.serve import generate
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.weights import params_from_jax

torch.set_num_threads(2)  # several test processes share the cores

B, S = 2, 24
# test_models_smoke.py's fp32 bar for prefill/decode against the full forward.
FP32 = dict(rtol=2e-4, atol=2e-4)


def _cfgs(dtype="float32", arch="granite-8b", **over):
    over = dict(param_dtype=dtype, activation_dtype=dtype, **over)
    jcfg = dataclasses.replace(jbase.get_config(arch).smoke(), **over)
    tcfg = dataclasses.replace(tbase.get_config(arch).smoke(), **over)
    return jcfg, tcfg


def _models(jcfg, tcfg, seed=0):
    jparams = jlm.init(jax.random.PRNGKey(seed), jcfg)
    model = lm.init(seed, tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    return jparams, model


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n)).astype(np.int32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


KV_CASES = pytest.mark.parametrize("over", [{}, {"n_kv_heads": 2}], ids=["mqa", "gqa2"])


@pytest.mark.parametrize("arch", sorted(jbase.all_configs()))
def test_configs_match_reference(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.smoke()) == dataclasses.asdict(jcfg.smoke())
    if jcfg.family == "recsys":
        return
    for shape in jbase.ALL_SHAPES:
        jspecs = jbase.cache_specs(jcfg, 2, shape.seq_len)
        tspecs = tbase.cache_specs(tcfg, 2, shape.seq_len)
        assert sorted(tspecs) == sorted(jspecs)
        for name, (tshape, tdt) in tspecs.items():
            assert tshape == jspecs[name].shape
            assert str(tdt).removeprefix("torch.") == jspecs[name].dtype.name


@KV_CASES
def test_forward_matches_reference_fp32(over):
    jcfg, tcfg = _cfgs(**over)
    jparams, model = _models(jcfg, tcfg)
    tok = _tokens(tcfg, S)
    expect, _ = jlm.forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg, remat="none")
    logits, aux = lm.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    np.testing.assert_allclose(_np(logits), np.asarray(expect), **FP32)
    assert float(aux) == 0.0


@KV_CASES
def test_prefill_and_decode_match_reference_fp32(over):
    jcfg, tcfg = _cfgs(**over)
    jparams, model = _models(jcfg, tcfg)
    tok = _tokens(tcfg, S + 1)
    jlogits, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(tok[:, :S])}, jcfg, pad_to=S + 4)
    logits, cache = lm.prefill(model, {"tokens": torch.from_numpy(tok[:, :S])}, tcfg, pad_to=S + 4)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **FP32)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        np.testing.assert_allclose(_np(cache[name]), np.asarray(jcache[name]), **FP32)

    jd, jcache2 = jlm.decode_step(
        jparams, {"token": jnp.asarray(tok[:, S]), "pos": jnp.int32(S), "cache": jcache}, jcfg
    )
    d, cache2 = lm.decode_step(
        model, {"token": torch.from_numpy(tok[:, S]), "pos": S, "cache": cache}, tcfg
    )
    np.testing.assert_allclose(_np(d), np.asarray(jd), **FP32)
    assert cache2["k"] is cache["k"]  # updated in place
    np.testing.assert_allclose(_np(cache2["k"]), np.asarray(jcache2["k"]), **FP32)


def _jax_generate(jparams, jcfg, tok, steps):
    """The greedy loop of repro.launch.serve (serve.py:45-66)."""
    S = tok.shape[1]
    prefill = jax.jit(lambda p, b: jlm.prefill(p, b, jcfg, pad_to=S + steps))
    decode = jax.jit(lambda p, b: jlm.decode_step(p, b, jcfg))
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(tok)})
    tokens = jnp.argmax(logits, axis=-1)
    generated = [tokens]
    for i in range(steps - 1):
        logits, cache = decode(jparams, {"token": tokens, "pos": jnp.int32(S + i), "cache": cache})
        tokens = jnp.argmax(logits, axis=-1)
        generated.append(tokens)
    return np.stack([np.asarray(t) for t in generated], axis=1)


@KV_CASES
def test_generate_matches_reference_greedy_fp32(over):
    jcfg, tcfg = _cfgs(**over)
    jparams, model = _models(jcfg, tcfg, seed=3)
    tok = _tokens(tcfg, 16, seed=3)
    expect = _jax_generate(jparams, jcfg, tok, 8)
    out = generate(model, torch.from_numpy(tok), 8)
    assert out.shape == (B, 8)
    np.testing.assert_array_equal(out.numpy(), expect)


@KV_CASES
def test_prefill_matches_reference_bf16(over):
    """JAX rounds scores and probabilities to bf16 (layers._sdpa) where the
    port keeps them in fp32, and 4 layers compound it: 3e-2 of max|ref|."""
    jcfg, tcfg = _cfgs("bfloat16", **over)
    jparams, model = _models(jcfg, tcfg)
    tok = _tokens(tcfg, S)
    jlogits, _ = jlm.prefill(jparams, {"tokens": jnp.asarray(tok)}, jcfg)
    logits, _ = lm.prefill(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    assert logits.dtype == torch.bfloat16
    ref = np.asarray(jlogits.astype(jnp.float32))
    assert np.abs(_np(logits) - ref).max() <= 3e-2 * np.abs(ref).max()


def test_init_draws_on_device_with_reference_shapes():
    jcfg, tcfg = _cfgs("bfloat16")
    model = lm.init(0, tcfg, device="cpu")
    ref = params_from_jax(jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg)), tcfg)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref)
    for name, t in sd.items():
        assert t.shape == ref[name].shape and t.dtype == torch.bfloat16, name
    assert float(sd["blocks.0.attn.norm"].abs().max()) == 0.0
    wq = sd["blocks.0.attn.wq"].float()
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(tcfg.d_model) + 1e-2
    # Same seed, same weights; another seed, other weights.
    assert torch.equal(lm.init(0, tcfg, device="cpu").embed, model.embed)
    assert not torch.equal(lm.init(1, tcfg, device="cpu").embed, model.embed)


# ---------------------------------------------------------------------------
# qwen3-moe-30b-a3b (the MoE family): its smoke config is dropless
# (capacity 4.0), so prefill and decode route exactly as the full forward.
# ---------------------------------------------------------------------------

MOE = "qwen3-moe-30b-a3b"


def test_moe_forward_and_aux_match_reference_fp32():
    jcfg, tcfg = _cfgs(arch=MOE)
    jparams, model = _models(jcfg, tcfg)
    tok = _tokens(tcfg, S)
    expect, expect_aux = jlm.forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg, remat="none")
    logits, aux = lm.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    np.testing.assert_allclose(_np(logits), np.asarray(expect), **FP32)
    assert float(expect_aux) > 0.0  # summed over layers, as the reference does
    np.testing.assert_allclose(float(aux), float(expect_aux), **FP32)


def test_moe_prefill_and_decode_match_reference_fp32():
    jcfg, tcfg = _cfgs(arch=MOE)
    jparams, model = _models(jcfg, tcfg, seed=1)
    tok = _tokens(tcfg, S + 1, seed=1)
    jlogits, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(tok[:, :S])}, jcfg, pad_to=S + 4)
    logits, cache = lm.prefill(model, {"tokens": torch.from_numpy(tok[:, :S])}, tcfg, pad_to=S + 4)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **FP32)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        np.testing.assert_allclose(_np(cache[name]), np.asarray(jcache[name]), **FP32)

    jd, _ = jlm.decode_step(
        jparams, {"token": jnp.asarray(tok[:, S]), "pos": jnp.int32(S), "cache": jcache}, jcfg
    )
    d, _ = lm.decode_step(
        model, {"token": torch.from_numpy(tok[:, S]), "pos": S, "cache": cache}, tcfg
    )
    np.testing.assert_allclose(_np(d), np.asarray(jd), **FP32)


def test_moe_generate_matches_reference_greedy_fp32():
    jcfg, tcfg = _cfgs(arch=MOE)
    jparams, model = _models(jcfg, tcfg, seed=3)
    tok = _tokens(tcfg, 16, seed=3)
    expect = _jax_generate(jparams, jcfg, tok, 8)
    out = generate(model, torch.from_numpy(tok), 8)
    assert out.shape == (B, 8)
    np.testing.assert_array_equal(out.numpy(), expect)


def test_moe_prefill_matches_reference_bf16():
    """bf16, layer by layer on the reference's own residual stream, at the
    dense case's bar (3e-2 of max|ref|) for every layer and for the logits.

    Run end to end instead, the two packages' streams part by an ulp after
    the first attention (JAX rounds scores and probabilities to bf16), and
    with 4 experts that flips a near-tied top-2 choice for one token on
    seeds 0 and 2 of 0-3: another routing, which moves the logits past the
    bar, not an arithmetic error.  Fed the same input, each layer must agree.
    """
    jcfg, tcfg = _cfgs("bfloat16", arch=MOE)
    jparams, model = _models(jcfg, tcfg)
    tok = _tokens(tcfg, S)
    x = jparams["embed"][jnp.asarray(tok)].astype(jnp.bfloat16)
    jpos, tpos = jnp.arange(S)[None, :], torch.arange(S)[None, :]

    def close(out, ref):
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.abs(_np(out) - ref).max() <= 3e-2 * np.abs(ref).max()

    for i, blk in enumerate(model.blocks):
        jblk = jax.tree.map(lambda a, i=i: a[i], jparams["blocks"])
        expect, _ = jT._self_block_apply(jblk, x, jcfg, None, jpos)
        out, _, _, _ = T._self_block_apply(blk, torch.from_numpy(_np(x)).bfloat16(), tcfg, tpos)
        assert out.dtype == torch.bfloat16
        close(out, expect)
        x = expect
    last = torch.from_numpy(_np(x[:, -1])).bfloat16()
    close(L.rms_norm(last, model.final_norm) @ model.head(),
          jL.rms_norm(x[:, -1], jparams["final_norm"]) @ jparams["lm_head"])


def test_moe_weights_keep_the_router_in_fp32():
    jcfg, tcfg = _cfgs("bfloat16", arch=MOE)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    sd = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    model_sd = lm.init(0, tcfg, device="cpu").state_dict()
    assert sorted(sd) == sorted(model_sd)
    for name, t in sd.items():
        want = torch.float32 if name.endswith(".moe.router") else torch.bfloat16
        assert t.dtype == want and model_sd[name].dtype == want, name
        assert t.shape == model_sd[name].shape, name
    router = np.asarray(jparams["blocks"]["moe"]["router"][1])
    assert np.array_equal(sd["blocks.1.moe.router"].numpy(), router)  # not rounded


# ---------------------------------------------------------------------------
# falcon-mamba-7b (ssm) and recurrentgemma-9b (hybrid).  S = 24 is past the
# Griffin smoke window (16), so its K/V cache is the rolled ring buffer.
# ---------------------------------------------------------------------------

RECURRENT = pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
FP32_LEAVES = ("b_dt", "a_log", "d_skip", "lambda_p")


@RECURRENT
def test_recurrent_families_init_with_reference_shapes(arch):
    jcfg, tcfg = _cfgs("bfloat16", arch=arch)
    model = lm.init(0, tcfg, device="cpu")
    ref = params_from_jax(jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg)), tcfg)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref)
    for name, t in sd.items():
        want = torch.float32 if name.rsplit(".", 1)[-1] in FP32_LEAVES else torch.bfloat16
        assert t.shape == ref[name].shape and t.dtype == want == ref[name].dtype, name
    n_layers = len(model.blocks if arch == "falcon-mamba-7b" else model.layers)
    assert n_layers == tcfg.n_layers
    assert torch.equal(lm.init(0, tcfg, device="cpu").embed, model.embed)


@RECURRENT
def test_recurrent_forward_matches_reference_fp32(arch):
    jcfg, tcfg = _cfgs(arch=arch)
    jparams, model = _models(jcfg, tcfg)
    tok = _tokens(tcfg, S)
    expect, _ = jlm.forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg, remat="none")
    logits, aux = lm.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    np.testing.assert_allclose(_np(logits), np.asarray(expect), **FP32)
    assert float(aux) == 0.0


@RECURRENT
def test_recurrent_prefill_and_decode_match_reference_fp32(arch):
    jcfg, tcfg = _cfgs(arch=arch)
    jparams, model = _models(jcfg, tcfg, seed=1)
    tok = _tokens(tcfg, S + 1, seed=1)
    jlogits, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(tok[:, :S])}, jcfg, pad_to=S + 4)
    logits, cache = lm.prefill(model, {"tokens": torch.from_numpy(tok[:, :S])}, tcfg, pad_to=S + 4)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **FP32)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        np.testing.assert_allclose(_np(cache[name]), np.asarray(jcache[name]), **FP32)

    jd, jcache2 = jlm.decode_step(
        jparams, {"token": jnp.asarray(tok[:, S]), "pos": jnp.int32(S), "cache": jcache}, jcfg
    )
    d, cache2 = lm.decode_step(
        model, {"token": torch.from_numpy(tok[:, S]), "pos": S, "cache": cache}, tcfg
    )
    np.testing.assert_allclose(_np(d), np.asarray(jd), **FP32)
    for name in cache2:
        assert cache2[name] is cache[name]  # updated in place
        np.testing.assert_allclose(_np(cache2[name]), np.asarray(jcache2[name]), **FP32)


@RECURRENT
def test_recurrent_generate_matches_reference_greedy_fp32(arch):
    jcfg, tcfg = _cfgs(arch=arch)
    jparams, model = _models(jcfg, tcfg, seed=3)
    tok = _tokens(tcfg, S, seed=3)
    expect = _jax_generate(jparams, jcfg, tok, 8)
    out = generate(model, torch.from_numpy(tok), 8)
    assert out.shape == (B, 8)
    np.testing.assert_array_equal(out.numpy(), expect)


@RECURRENT
def test_recurrent_prefill_matches_reference_bf16(arch):
    """bf16 rounds at other places in the two packages (XLA fuses elementwise
    chains that PyTorch rounds step by step): the dense bar, 3e-2 of max|ref|."""
    jcfg, tcfg = _cfgs("bfloat16", arch=arch)
    jparams, model = _models(jcfg, tcfg)
    tok = _tokens(tcfg, S)
    jlogits, _ = jlm.prefill(jparams, {"tokens": jnp.asarray(tok)}, jcfg)
    logits, _ = lm.prefill(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    assert logits.dtype == torch.bfloat16
    ref = np.asarray(jlogits.astype(jnp.float32))
    assert np.abs(_np(logits) - ref).max() <= 3e-2 * np.abs(ref).max()


def test_griffin_decode_below_the_window_matches_the_reference_clamped_write():
    """A prompt shorter than the window leaves an S-long K/V cache.  The
    reference's decode writes slot pos = S, which lax.dynamic_update_slice
    clamps to S-1 (over the last prompt key); the port does the same."""
    jcfg, tcfg = _cfgs(arch="recurrentgemma-9b")
    jparams, model = _models(jcfg, tcfg, seed=2)
    Sp = 10
    assert Sp < tcfg.attn_window
    tok = _tokens(tcfg, Sp + 1, seed=2)
    _, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(tok[:, :Sp])}, jcfg)
    _, cache = lm.prefill(model, {"tokens": torch.from_numpy(tok[:, :Sp])}, tcfg)
    assert cache["k"].shape[3] == Sp
    before = cache["k"].clone()
    jd, jcache2 = jlm.decode_step(
        jparams, {"token": jnp.asarray(tok[:, Sp]), "pos": jnp.int32(Sp), "cache": jcache}, jcfg
    )
    d, cache2 = lm.decode_step(
        model, {"token": torch.from_numpy(tok[:, Sp]), "pos": Sp, "cache": cache}, tcfg
    )
    np.testing.assert_allclose(_np(d), np.asarray(jd), **FP32)
    np.testing.assert_allclose(_np(cache2["k"]), np.asarray(jcache2["k"]), **FP32)
    assert torch.equal(cache2["k"][..., :Sp - 1, :], before[..., :Sp - 1, :])
    assert not torch.equal(cache2["k"][..., Sp - 1, :], before[..., Sp - 1, :])
