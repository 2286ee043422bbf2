"""The port's llama-3.2-vision-11b (vlm) and hubert-xlarge (audio) smoke
models against the JAX package's, on the same weights (copied in with
``params_from_jax``) and the same numpy prompts, images and frames.

The VLM's cross-attention gates start at 0, where ``tanh(0) = 0`` throws the
cross-attention away; every VLM comparison here sets them to 0.5 in the JAX
parameters before both packages run, and one test shows the gate matters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.models import transformer as jT
from repro_torch.configs import base as tbase
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.weights import params_from_jax

torch.set_num_threads(2)  # several test processes share the cores

VLM, AUDIO = "llama-3.2-vision-11b", "hubert-xlarge"
B, S = 2, 24
# test_models_smoke.py's fp32 bar.
FP32 = dict(rtol=2e-4, atol=2e-4)
GATE = 0.5
# The VLM smoke config has 4 heads over 1 kv head; also 2 and 4 (KV = H).
KV_CASES = pytest.mark.parametrize("kv", [1, 2, 4], ids=["mqa", "gqa2", "mha"])


def _cfgs(arch, dtype="float32", **over):
    over = dict(param_dtype=dtype, activation_dtype=dtype, **over)
    jcfg = dataclasses.replace(jbase.get_config(arch).smoke(), **over)
    tcfg = dataclasses.replace(tbase.get_config(arch).smoke(), **over)
    return jcfg, tcfg


def _with_gate(jparams, gate):
    """The JAX parameters with every cross block's gate set to ``gate``."""
    blocks = dict(jparams["blocks"])
    cross = dict(blocks["cross"])
    attn = dict(cross["attn"])
    attn["gate"] = jnp.full_like(attn["gate"], gate)
    cross["attn"] = attn
    blocks["cross"] = cross
    return {**jparams, "blocks": blocks}


def _models(jcfg, tcfg, seed=0, gate=GATE):
    jparams = jlm.init(jax.random.PRNGKey(seed), jcfg)
    if jcfg.family == "vlm":
        jparams = _with_gate(jparams, gate)
    model = lm.init(seed, tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    return jparams, model


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n)).astype(np.int32)


def _image(cfg, seed=0):
    rng = np.random.default_rng(seed + 100)
    return rng.standard_normal((B, cfg.img_tokens, cfg.d_model)).astype(np.float32)


def _frames(cfg, n, seed=0):
    rng = np.random.default_rng(seed + 200)
    return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _jbatch(dtype=jnp.float32, **arrays):
    return {k: jnp.asarray(v) if v.dtype.kind == "i" else jnp.asarray(v, dtype)
            for k, v in arrays.items()}


def _tbatch(dtype=torch.float32, **arrays):
    return {k: torch.from_numpy(v) if v.dtype.kind == "i" else torch.from_numpy(v).to(dtype)
            for k, v in arrays.items()}


def _close_bf16(out, ref):
    """JAX rounds scores and probabilities to bf16 (layers._sdpa) where the
    port keeps them in fp32: 3e-2 of max|ref|, as for the dense family."""
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(_np(out) - ref).max() <= 3e-2 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# llama-3.2-vision-11b (vlm)
# ---------------------------------------------------------------------------


@KV_CASES
def test_vlm_forward_matches_reference_fp32(kv):
    jcfg, tcfg = _cfgs(VLM, n_kv_heads=kv)
    jparams, model = _models(jcfg, tcfg)
    arrays = dict(tokens=_tokens(tcfg, S), image_embeds=_image(tcfg))
    expect, _ = jlm.forward(jparams, _jbatch(**arrays), jcfg, remat="none")
    logits, aux = lm.forward(model, _tbatch(**arrays), tcfg)
    np.testing.assert_allclose(_np(logits), np.asarray(expect), **FP32)
    assert float(aux) == 0.0


@KV_CASES
def test_vlm_prefill_and_decode_match_reference_fp32(kv):
    jcfg, tcfg = _cfgs(VLM, n_kv_heads=kv)
    jparams, model = _models(jcfg, tcfg, seed=1)
    tok, img = _tokens(tcfg, S + 1, seed=1), _image(tcfg, seed=1)
    arrays = dict(tokens=tok[:, :S], image_embeds=img)
    jlogits, jcache = jlm.prefill(jparams, _jbatch(**arrays), jcfg, pad_to=S + 4)
    logits, cache = lm.prefill(model, _tbatch(**arrays), tcfg, pad_to=S + 4)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **FP32)
    assert sorted(cache) == sorted(jcache) == ["k", "v", "xk", "xv"]
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


def _jax_generate(jparams, jcfg, tok, img, steps):
    """The greedy loop of repro.launch.serve (serve.py:45-66), with the image."""
    S = tok.shape[1]
    prefill = jax.jit(lambda p, b: jlm.prefill(p, b, jcfg, pad_to=S + steps))
    decode = jax.jit(lambda p, b: jlm.decode_step(p, b, jcfg))
    logits, cache = prefill(jparams, _jbatch(tokens=tok, image_embeds=img))
    tokens = jnp.argmax(logits, axis=-1)
    generated = [tokens]
    for i in range(steps - 1):
        logits, cache = decode(jparams, {"token": tokens, "pos": jnp.int32(S + i), "cache": cache})
        tokens = jnp.argmax(logits, axis=-1)
        generated.append(tokens)
    return np.stack([np.asarray(t) for t in generated], axis=1)


@KV_CASES
def test_vlm_generate_matches_reference_greedy_fp32(kv):
    jcfg, tcfg = _cfgs(VLM, n_kv_heads=kv)
    jparams, model = _models(jcfg, tcfg, seed=3)
    tok, img = _tokens(tcfg, 16, seed=3), _image(tcfg, seed=3)
    expect = _jax_generate(jparams, jcfg, tok, img, 8)
    out = generate(model, torch.from_numpy(tok), 8, image_embeds=torch.from_numpy(img))
    assert out.shape == (B, 8)
    np.testing.assert_array_equal(out.numpy(), expect)


@KV_CASES
def test_vlm_prefill_matches_reference_bf16(kv):
    jcfg, tcfg = _cfgs(VLM, "bfloat16", n_kv_heads=kv)
    jparams, model = _models(jcfg, tcfg)
    arrays = dict(tokens=_tokens(tcfg, S), image_embeds=_image(tcfg))
    jlogits, _ = jlm.prefill(jparams, _jbatch(jnp.bfloat16, **arrays), jcfg)
    logits, _ = lm.prefill(model, _tbatch(torch.bfloat16, **arrays), tcfg)
    assert logits.dtype == torch.bfloat16
    _close_bf16(logits, jlogits)


def test_vlm_gate_changes_the_logits():
    """At gate 0 the image is thrown away; at 0.5 it moves the logits in both
    packages alike, so the comparisons above see the cross-attention."""
    jcfg, tcfg = _cfgs(VLM)
    arrays = dict(tokens=_tokens(tcfg, S), image_embeds=_image(tcfg))
    out = {}
    for gate in (0.0, GATE):
        jparams, model = _models(jcfg, tcfg, gate=gate)
        expect, _ = jlm.forward(jparams, _jbatch(**arrays), jcfg, remat="none")
        logits, _ = lm.forward(model, _tbatch(**arrays), tcfg)
        np.testing.assert_allclose(_np(logits), np.asarray(expect), **FP32)
        other = dict(arrays, image_embeds=_image(tcfg, seed=9))
        moved, _ = lm.forward(model, _tbatch(**other), tcfg)
        out[gate] = (_np(logits), _np(moved))
    closed, opened = out[0.0], out[GATE]
    np.testing.assert_array_equal(closed[0], closed[1])  # another image changes nothing
    assert np.abs(opened[0] - opened[1]).max() > 1e-3   # at 0.5 it does
    assert np.abs(opened[0] - closed[0]).max() > 1e-3


def test_vlm_without_an_image_raises():
    """Without image_embeds the cross layers would have nothing to attend to;
    the reference fails there too (``image_embeds.astype`` on None)."""
    _, tcfg = _cfgs(VLM)
    model = lm.init(0, tcfg, device="cpu")
    batch = _tbatch(tokens=_tokens(tcfg, S))
    for entry in (lm.forward, lm.prefill):
        with pytest.raises(ValueError, match="image_embeds"):
            entry(model, batch, tcfg)


def test_vlm_init_draws_on_device_with_reference_shapes():
    jcfg, tcfg = _cfgs(VLM, "bfloat16")
    model = lm.init(0, tcfg, device="cpu")
    ref = params_from_jax(jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg)), tcfg)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref)
    for name, t in sd.items():
        assert t.shape == ref[name].shape and t.dtype == torch.bfloat16, name
    kinds = [type(b).__name__ for b in model.blocks]
    assert kinds == ["Block", "CrossBlock"] * 2  # cross_attn_every 2 at smoke size
    assert [T.is_cross_layer(tcfg, i) for i in range(4)] == [False, True, False, True]
    assert sd["blocks.1.attn.gate"].shape == () and float(sd["blocks.1.attn.gate"]) == 0.0
    assert "blocks.0.attn.gate" not in sd and "blocks.1.attn.xnorm" in sd
    assert torch.equal(lm.init(0, tcfg, device="cpu").embed, model.embed)


def test_vlm_layer_order_follows_the_reference_stacks():
    """Full config: 8 super-blocks of 4 self layers and a cross layer, and the
    caches' layer counts of ``cache_specs``."""
    cfg = tbase.get_config(VLM)
    cross = [i for i in range(cfg.n_layers) if T.is_cross_layer(cfg, i)]
    assert cross == [4, 9, 14, 19, 24, 29, 34, 39]
    specs = tbase.cache_specs(cfg, 4, 1016)
    assert specs["k"][0][0] == cfg.n_layers - len(cross) == 32
    assert specs["xk"][0] == (8, 4, 8, 1601, 128)


@pytest.mark.parametrize("where", ["self", "self_inner", "cross"])
def test_params_from_jax_refuses_a_wrong_vlm_depth(where):
    jcfg, tcfg = _cfgs(VLM)
    np_params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
    stack = np_params["blocks"]["cross" if where == "cross" else "self"]
    cut = (lambda a: a[:, :0]) if where == "self_inner" else (lambda a: a[:1])
    stack["attn"]["wq"] = cut(stack["attn"]["wq"])
    with pytest.raises(ValueError, match=r"blocks\.(self|cross)\.attn\.wq"):
        params_from_jax(np_params, tcfg)


def test_serve_main_draws_the_reference_image(capsys, monkeypatch):
    """``main`` serves the VLM on the CPU, and the image it prefills with is
    ``repro.launch.serve``'s draw: the same rng, after the prompt."""
    seen = {}
    real = serve.generate

    def spy(model, tokens, steps, timings=None, image_embeds=None):
        seen["tokens"], seen["img"] = tokens, image_embeds
        return real(model, tokens, steps, timings, image_embeds)

    monkeypatch.setattr(serve, "generate", spy)
    serve.main(["--arch", VLM, "--smoke", "--batch", "2", "--prompt-len", "8",
                "--decode-steps", "4", "--seed", "7", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("prefill: 2x8 in ")
    assert out[3].startswith("generated ids (first seq):")

    cfg = jbase.get_config(VLM).smoke()
    rng = np.random.default_rng(7)  # repro.launch.serve's draws, in its order
    tokens = jnp.array(rng.integers(0, cfg.vocab, (2, 8)), jnp.int32)
    img = jnp.array(rng.standard_normal((2, cfg.img_tokens, cfg.d_model)),
                    jnp.dtype(cfg.activation_dtype))
    np.testing.assert_array_equal(seen["tokens"].numpy(), np.asarray(tokens))
    assert seen["img"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(seen["img"]), np.asarray(img, np.float32))


# ---------------------------------------------------------------------------
# hubert-xlarge (audio): an encoder over frames, no decode
# ---------------------------------------------------------------------------


def test_audio_forward_matches_reference_fp32():
    jcfg, tcfg = _cfgs(AUDIO)
    jparams, model = _models(jcfg, tcfg)
    frames = _frames(tcfg, S)
    expect, _ = jlm.forward(jparams, _jbatch(frames=frames), jcfg, remat="none")
    logits, aux = lm.forward(model, _tbatch(frames=frames), tcfg)
    assert tuple(logits.shape) == (B, S, tcfg.vocab)
    np.testing.assert_allclose(_np(logits), np.asarray(expect), **FP32)
    assert float(aux) == 0.0


def test_audio_prefill_matches_reference_fp32():
    """The reference's encoder prefill: the full sequence's logits, no cache."""
    jcfg, tcfg = _cfgs(AUDIO)
    jparams, model = _models(jcfg, tcfg, seed=1)
    frames = _frames(tcfg, S, seed=1)
    jlogits, jcache = jlm.prefill(jparams, _jbatch(frames=frames), jcfg)
    logits, cache = lm.prefill(model, _tbatch(frames=frames), tcfg)
    assert cache == {} == jcache
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **FP32)


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_audio_matches_reference_bf16(entry):
    jcfg, tcfg = _cfgs(AUDIO, "bfloat16")
    jparams, model = _models(jcfg, tcfg)
    frames = _frames(tcfg, S)
    expect, _ = getattr(jlm, entry)(jparams, _jbatch(jnp.bfloat16, frames=frames), jcfg)
    out, _ = getattr(lm, entry)(model, _tbatch(torch.bfloat16, frames=frames), tcfg)
    assert out.dtype == torch.bfloat16
    _close_bf16(out, expect)


def test_audio_block_is_bidirectional_without_rope():
    """Changing the last frame moves the first position's logits (no causal
    mask), and one frame repeated at every position gives every position the
    same first-layer output (no rope), in both packages alike."""
    jcfg, tcfg = _cfgs(AUDIO)
    jparams, model = _models(jcfg, tcfg)
    frames = _frames(tcfg, S)
    base, _ = lm.forward(model, _tbatch(frames=frames), tcfg)
    frames2 = frames.copy()
    frames2[:, -1] += 1.0
    moved, _ = lm.forward(model, _tbatch(frames=frames2), tcfg)
    assert bool((moved[:, 0] - base[:, 0]).abs().max() > 1e-4)
    same = np.repeat(frames[:, :1], S, axis=1)
    expect, _ = jT._self_block_apply(jax.tree.map(lambda a: a[0], jparams["blocks"]),
                                     jnp.asarray(same), jcfg, None, jnp.arange(S)[None, :])
    out, _, _, _ = T._self_block_apply(model.blocks[0], torch.from_numpy(same), tcfg,
                                       torch.arange(S)[None, :])
    np.testing.assert_allclose(_np(out), np.asarray(expect), **FP32)
    np.testing.assert_allclose(_np(out), np.broadcast_to(_np(out)[:, :1], out.shape), **FP32)


def test_audio_init_has_no_embed_and_gelu_mlps():
    jcfg, tcfg = _cfgs(AUDIO, "bfloat16")
    model = lm.init(0, tcfg, device="cpu")
    ref = params_from_jax(jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg)), tcfg)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref)
    for name, t in sd.items():
        assert t.shape == ref[name].shape and t.dtype == torch.bfloat16, name
    assert model.embed is None and "embed" not in sd
    assert "blocks.0.mlp.w1" in sd and "blocks.0.mlp.wg" not in sd
    assert tuple(model.head().shape) == (tcfg.d_model, tcfg.vocab)


def test_params_from_jax_refuses_a_wrong_audio_depth():
    jcfg, tcfg = _cfgs(AUDIO)
    np_params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
    np_params["blocks"]["mlp"]["w1"] = np_params["blocks"]["mlp"]["w1"][:-1]
    with pytest.raises(ValueError, match=r"blocks\.mlp\.w1"):
        params_from_jax(np_params, tcfg)


def test_audio_has_no_decode():
    _, tcfg = _cfgs(AUDIO)
    model = lm.init(0, tcfg, device="cpu")
    tok = torch.zeros(B, dtype=torch.int64)
    with pytest.raises(ValueError, match="encoder-only"):
        lm.decode_step(model, {"token": tok, "pos": 0, "cache": {}}, tcfg)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", AUDIO, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_encoder_at_head_dim_80(dtype):
    """hubert-xlarge's head dim (80) at a narrow width: 2 heads of 80."""
    jcfg, tcfg = _cfgs(AUDIO, dtype, d_model=160, n_heads=2, n_kv_heads=2, head_dim=80,
                       d_ff=320, n_layers=2)
    jparams, model = _models(jcfg, tcfg, seed=4)
    frames = _frames(tcfg, 37, seed=4)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    expect, _ = jlm.forward(jparams, _jbatch(jdt, frames=frames), jcfg, remat="none")
    logits, _ = lm.forward(model, _tbatch(tdt, frames=frames), tcfg)
    if dtype == "float32":
        np.testing.assert_allclose(_np(logits), np.asarray(expect), **FP32)
    else:
        _close_bf16(logits, expect)
