"""The port's training loss, gradients and train step against the JAX
package's, on the same weights (copied in with ``params_from_jax``) and the
same numpy batches.  The reference's gradient pytree goes through
``params_from_jax`` too, so gradients compare name by name."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import sgd_momentum as jsgd
from repro.optim import wsd as jwsd
from repro.parallel.sharding import ShardingPlan
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import DataSpec, batch_for_step
from repro_torch.models import lm
from repro_torch.optim import adamw, sgd_momentum, wsd
from repro_torch.train.steps import make_train_step
from repro_torch.weights import params_from_jax

torch.set_num_threads(2)  # several test processes share the cores

B, S = 2, 20
GRAD_RTOL = 1e-4  # of max|g| per leaf: fp32, the same math summed in another order


def _cfgs(arch, **over):
    over = dict(param_dtype="float32", activation_dtype="float32", **over)
    jcfg = dataclasses.replace(jbase.get_config(arch).smoke(), **over)
    tcfg = dataclasses.replace(tbase.get_config(arch).smoke(), **over)
    return jcfg, tcfg


def _models(jcfg, tcfg, seed=0):
    jparams = jlm.init(jax.random.PRNGKey(seed), jcfg)
    if jcfg.family == "vlm":  # at 0, tanh(0) throws the cross-attention away
        cross = jparams["blocks"]["cross"]["attn"]
        cross["gate"] = jnp.full_like(cross["gate"], 0.5)
    model = lm.init(seed, tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    return jparams, model


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _loss_and_grads(arch, remat, loss_chunk):
    jcfg, tcfg = _cfgs(arch)
    jparams, model = _models(jcfg, tcfg)
    batch = _batch(tcfg)
    (jtotal, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                              remat=remat, loss_chunk=loss_chunk),
        has_aux=True,
    )(jparams)
    model.requires_grad_(True)
    total, metrics = lm.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
                                remat=remat, loss_chunk=loss_chunk)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    expect = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    assert sorted(expect) == sorted(params)
    return (float(jtotal), jmetrics), (total.detach(), metrics), dict(zip(params, grads)), expect


def _assert_grads_close(grads, expect):
    for name, want in expect.items():
        got = grads[name]
        got = torch.zeros_like(want) if got is None else got.detach()
        bar = GRAD_RTOL * max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max())
        assert err <= bar, f"{name}: max|err| {err} > {bar}"


@pytest.mark.parametrize("loss_chunk", [0, 8])
@pytest.mark.parametrize("remat", ["full", "dots", "none"])
@pytest.mark.parametrize("arch", ["granite-8b", "minicpm-2b"])  # GQA untied; MHA tied
def test_loss_and_every_gradient_match_reference(arch, remat, loss_chunk):
    (jtotal, jmetrics), (total, metrics), grads, expect = _loss_and_grads(arch, remat, loss_chunk)
    assert total.dtype == torch.float32 and total.shape == ()
    np.testing.assert_allclose(float(total), jtotal, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["xent"].detach()), float(jmetrics["xent"]),
                               rtol=1e-5)
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
    _assert_grads_close(grads, expect)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "falcon-mamba-7b", "recurrentgemma-9b",
                                  "llama-3.2-vision-11b", "hubert-xlarge"])
def test_loss_and_gradients_of_the_other_families_match_reference(arch):
    """Every family trains on the CPU; on the card the families whose
    kernels have no backward yet raise (test_torch_gpu.py)."""
    (jtotal, jmetrics), (total, metrics), grads, expect = _loss_and_grads(arch, "full", 8)
    np.testing.assert_allclose(float(total), jtotal, rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key].detach()), float(jmetrics[key]),
                                   rtol=1e-5, atol=1e-7)
    _assert_grads_close(grads, expect)


def test_chunked_loss_equals_the_full_loss():
    """The chunked CE (a padded tail: 20 = 2 x 8 + 4) is the full CE."""
    _, tcfg = _cfgs("minicpm-2b")
    model = lm.init(0, tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    full, _ = lm.loss_fn(model, batch, tcfg, loss_chunk=0)
    for chunk in (8, 20, 64):
        part, _ = lm.loss_fn(model, batch, tcfg, loss_chunk=chunk)
        torch.testing.assert_close(part, full, rtol=1e-6, atol=1e-6)


def _steps(arch, opt_pair, n_steps=3):
    """n_steps of both packages' train steps from the same weights on the
    same batches -> (reference params, port model, per-step metrics)."""
    jcfg, tcfg = _cfgs(arch)
    jparams, model = _models(jcfg, tcfg)
    jopt, topt = opt_pair
    plan = ShardingPlan(fsdp=False, remat="full", loss_chunk=8)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, plan))
    tstep = make_train_step(tcfg, topt, remat="full", loss_chunk=8)
    jstate = jopt.init(jparams)
    tstate = topt.init(dict(model.named_parameters()))
    spec = DataSpec(cfg=tcfg, shape=tbase.ShapeSpec("t", S, B, "train"), seed=1)
    seen = []
    for step in range(n_steps):
        batch = batch_for_step(spec, step)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jnp.int32(step))
        _, _, tm = tstep(model, tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, step)
        seen.append((jm, tm))
    return jparams, model, seen


@pytest.mark.parametrize("arch", ["granite-8b", "minicpm-2b"])
def test_sgd_momentum_steps_match_reference(arch):
    jparams, model, seen = _steps(arch, (jsgd(lambda s: jnp.float32(0.05)),
                                         sgd_momentum(lambda s: 0.05)))
    for jm, tm in seen:
        for key in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
    expect = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg)
    for name, p in model.named_parameters():
        bar = 1e-4 * float(expect[name].abs().max())
        assert float((p.detach() - expect[name]).abs().max()) <= bar, name


@pytest.mark.parametrize("arch", ["granite-8b", "minicpm-2b"])
def test_adamw_wsd_steps_match_reference(arch):
    """AdamW's step is about lr * sign(g) per entry, so it amplifies the
    gradients' rounding differences where |g| is small: the parameters are
    held to 1e-4 max|p|, the gradients' own bar."""
    jparams, model, seen = _steps(arch, (jadamw(jwsd(1e-3, 10)), adamw(wsd(1e-3, 10))))
    for jm, tm in seen:
        for key in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
    expect = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg)
    for name, p in model.named_parameters():
        bar = 1e-4 * float(expect[name].abs().max())
        assert float((p.detach() - expect[name]).abs().max()) <= bar, name


def test_serving_builds_no_graph_after_training_flips_requires_grad():
    """Training makes the parameters trainable; the serving entry points stay
    under no_grad, so they keep no autograd graph (and no saved tensors)."""
    _, tcfg = _cfgs("minicpm-2b")
    model = lm.init(0, tcfg, device="cpu").requires_grad_(True)
    tokens = torch.from_numpy(_batch(tcfg)["tokens"])
    logits, _ = lm.forward(model, {"tokens": tokens}, tcfg)
    last, cache = lm.prefill(model, {"tokens": tokens}, tcfg, pad_to=S + 1)
    assert logits.grad_fn is None and last.grad_fn is None
    assert all(t.grad_fn is None for t in cache.values())


def test_unknown_remat_policy_raises():
    _, tcfg = _cfgs("minicpm-2b")
    model = lm.init(0, tcfg, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        lm.loss_fn(model, {"tokens": torch.from_numpy(_batch(tcfg)["tokens"])}, tcfg,
                   remat="some")
