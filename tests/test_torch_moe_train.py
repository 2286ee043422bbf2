"""Training the MoE family: the grouped matmul's backward and the MoE layer's
gradients against the JAX package, on the CPU.

``ref_moe_gmm_bwd`` (the plain version of ``csrc/moe_gmm_bwd.cu``) against
``jax.vjp`` of the reference's ``ref_moe_gmm``; :class:`GroupedMatmulFn` on
the plain versions against autograd of ``ref_moe_gmm``; ``layers.moe``'s
input and weight gradients against ``jax.grad`` of ``repro.models.layers.moe``
on the same weights, with and without drops; the backward's tiling choice;
and three AdamW steps of qwen3-moe's smoke config through both packages'
train steps.  Nothing here reaches a CUDA kernel: the card's side is
``chip_smoke.py`` and the ``gpu`` tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ref as jref
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import wsd as jwsd
from repro.parallel.sharding import ShardingPlan
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import DataSpec, batch_for_step
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import (
    BWD_TILINGS, GroupedMatmulFn, gmm_bwd_tiling, moe_gmm_bwd,
)
from repro_torch.kernels.ref import ref_moe_gmm, ref_moe_gmm_bwd
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import adamw, wsd
from repro_torch.train.steps import make_train_step
from repro_torch.weights import params_from_jax

torch.set_num_threads(2)  # several test processes share the cores

ARCH = "qwen3-moe-30b-a3b"
# test_kernels.py's moe_gmm shapes (E, C, D, F), and one ragged on every axis.
SHAPES = [(4, 128, 256, 128), (8, 64, 64, 256), (3, 77, 200, 136)]
# test_kernels.py's bars: fp32 only reorders sums; fp16/bf16 round the result.
TOL = {np.float32: 2e-5, "float16": 2e-2, "bfloat16": 2e-2}
GRAD_RTOL = 1e-5  # of each leaf's max|g|: fp32, the same math summed in another order
BWD_COUNTERS = ("grouped_matmul_launches", "grouped_matmul_wgmma_launches",
                "grouped_matmul_fma_launches", "grouped_matmul_skinny_launches",
                "grouped_matmul_bwd_launches", "grouped_matmul_bwd_wgmma_launches",
                "grouped_matmul_bwd_fma_launches")


def _xwdy(seed, E, C, D, F):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    dy = rng.standard_normal((E, C, F)).astype(np.float32)
    return x, w, dy


# ---------------------------------------------------------------------------
# (a) The plain backward against jax.vjp of the reference's oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", SHAPES)
def test_plain_gmm_bwd_matches_jax_vjp(E, C, D, F, dtype):
    """dx and dw of ``ref_moe_gmm_bwd`` against ``jax.vjp`` of
    ``repro.kernels.ref.ref_moe_gmm``; inputs rounded to the dtype from the
    same fp32 values on both sides; rtol/atol 2e-5 in fp32, 2e-2 in
    fp16/bf16 (each side rounds its fp32 sum once)."""
    x, w, dy = _xwdy(0, E, C, D, F)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw, jdy = (jnp.asarray(a).astype(jdt) for a in (x, w, dy))
    _, vjp = jax.vjp(jref.ref_moe_gmm, jx, jw)
    jdx, jdw = vjp(jdy)
    tdx, tdw = ref_moe_gmm_bwd(*(torch.from_numpy(a).to(tdt) for a in (x, w, dy)))
    assert tdx.dtype == tdw.dtype == tdt
    assert tdx.shape == (E, C, D) and tdw.shape == (E, D, F)
    tol = TOL[np.float32] if dtype == "float32" else TOL[dtype]
    for got, want in ((tdx, jdx), (tdw, jdw)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# (b) GroupedMatmulFn on the CPU, and the wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("needs", [(True, True), (True, False), (False, True)],
                         ids=["dx_dw", "dx", "dw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_fn_on_cpu_matches_autograd_of_plain(monkeypatch, dtype, needs):
    """Under grad, ``ops.grouped_matmul`` on the CPU goes through
    GroupedMatmulFn on the plain versions: the same output and the same
    gradients as autograd of ``ref_moe_gmm`` (both sum in fp32 and round
    once: equal to the bit), only the gradients asked for, and no launch
    counted."""
    for name in BWD_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    x, w, dy = (torch.from_numpy(a).to(dtype) for a in _xwdy(1, 3, 40, 64, 48))
    x.requires_grad_(needs[0])
    w.requires_grad_(needs[1])
    out = ops.grouped_matmul(x, w)
    assert type(out.grad_fn).__name__ == "GroupedMatmulFnBackward"
    wanted = [t for t, need in zip((x, w), needs) if need]
    got = torch.autograd.grad(out, wanted, dy)
    ref_out = ref_moe_gmm(x, w)
    expect = torch.autograd.grad(ref_out, wanted, dy)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    for g, e in zip(got, expect):
        assert g.dtype == dtype
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    assert all(getattr(ops, name) == 0 for name in BWD_COUNTERS)


def test_grouped_matmul_fn_backward_skips_what_needs_no_grad():
    """The Function's backward returns None for an input that needs no
    gradient, as ``ctx.needs_input_grad`` says."""
    x, w, dy = (torch.from_numpy(a) for a in _xwdy(2, 2, 5, 16, 8))
    x.requires_grad_(True)
    out = GroupedMatmulFn.apply(x, w)
    (gx,) = torch.autograd.grad(out, [x], dy)
    torch.testing.assert_close(gx, ref_moe_gmm_bwd(x.detach(), w, dy)[0], rtol=0, atol=0)
    assert w.grad is None


def test_grouped_matmul_without_grad_builds_no_graph():
    x, w, _ = (torch.from_numpy(a) for a in _xwdy(2, 2, 5, 16, 8))
    w.requires_grad_(True)
    with torch.no_grad():
        assert ops.grouped_matmul(x, w).grad_fn is None
    assert ops.grouped_matmul(x, w.detach()).grad_fn is None


@pytest.mark.parametrize("tiling", [None, *BWD_TILINGS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_wrapper_refuses_cpu_tensors(tiling, dtype):
    x, w, dy = (torch.from_numpy(a).to(dtype) for a in _xwdy(3, 2, 40, 64, 32))
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm_bwd(x, w, dy, tiling=tiling)


# ---------------------------------------------------------------------------
# (c) The MoE layer's gradients against jax.grad of the reference's layer
# ---------------------------------------------------------------------------


def _moe_pair(capacity_factor, seed=0):
    """qwen3-moe's smoke layer in fp32 in both packages, on the same weights."""
    over = dict(param_dtype="float32", activation_dtype="float32",
                capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jbase.get_config(ARCH).smoke(), **over)
    tcfg = dataclasses.replace(tbase.get_config(ARCH).smoke(), **over)
    jp = jL.init_moe(jax.random.PRNGKey(seed), jcfg)
    # The norm is zeros at init: a random one gives its gradient a non-trivial
    # path (scale 1 + norm).
    jp["norm"] = jnp.asarray(np.random.default_rng(seed + 1).standard_normal(
        jp["norm"].shape).astype(np.float32) * 0.1)
    mod = L.MoE(tcfg, torch.Generator().manual_seed(seed), torch.device("cpu"))
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jcfg, tcfg, jp, mod


@pytest.mark.parametrize("capacity_factor", [1.25, 1.0])
def test_moe_gradients_match_jax_grad(monkeypatch, capacity_factor):
    """The MoE layer behind its norm (as the block runs it), with a loss
    that reads every output and the aux loss: the input's and every
    weight's gradient (router, wg, wu, wd, norm) within 1e-5 of each leaf's
    max of ``jax.grad`` of the reference's layer.  At capacity 1.0 entries
    drop (checked), and their gradient must reach nothing."""
    jcfg, tcfg, jp, mod = _moe_pair(capacity_factor)
    rng = np.random.default_rng(4)
    B, S, D = 2, 24, tcfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    proj = rng.standard_normal((B, S, D)).astype(np.float32)

    def jloss(p, xin):
        out, aux = jL.moe(p, jL.rms_norm(xin, p["norm"]), jcfg)
        return jnp.sum(out * proj) + 0.5 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    monkeypatch.setattr(ops, "grouped_matmul_bwd_launches", 0)
    params = dict(mod.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = L.moe(mod, L.rms_norm(xt, mod.norm), tcfg)
    loss = (out * torch.from_numpy(proj)).sum() + 0.5 * aux
    grads = torch.autograd.grad(loss, [*params.values(), xt])
    assert ops.grouped_matmul_bwd_launches == 0  # the plain versions, on the CPU
    got = dict(zip([*params, "x"], grads))
    want = {**{k: np.asarray(v) for k, v in jgp.items()}, "x": np.asarray(jgx)}
    assert sorted(got) == sorted(want) == ["norm", "router", "wd", "wg", "wu", "x"]
    for name, w in want.items():
        bar = GRAD_RTOL * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[name].numpy() - w).max())
        assert float(np.abs(w).max()) > 0, name
        assert err <= bar, f"{name}: max|err| {err} > {bar}"

    N, K, E = B * S, tcfg.top_k, tcfg.n_experts
    C = max(1, int(capacity_factor * N * K / E))
    xn = L.rms_norm(torch.from_numpy(x), mod.norm.detach()).reshape(N, D)
    counts = torch.bincount(torch.topk(xn @ mod.router.detach(), K, dim=-1).indices.reshape(-1),
                            minlength=E)
    if capacity_factor == 1.0:
        assert bool((counts > C).any())


# ---------------------------------------------------------------------------
# (d) The backward's tiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,C,D,F,want",
    [
        # qwen3-moe-30b-a3b's training products (C = 1280): gate/up and down.
        (torch.bfloat16, 1280, 2048, 768, "wgmma"),
        (torch.bfloat16, 1280, 768, 2048, "wgmma"),
        (torch.float16, 1280, 2048, 768, "wgmma"),
        (torch.float32, 1280, 2048, 768, "fma"),
        # Any C: a decode-sized batch and a ragged one stay on wgmma.
        (torch.bfloat16, 1, 2048, 768, "wgmma"),
        (torch.bfloat16, 129, 72, 136, "wgmma"),
        # D or F off TMA's 16-byte strides.
        (torch.bfloat16, 77, 201, 136, "fma"),
        (torch.float16, 77, 200, 135, "fma"),
        (torch.float32, 1, 32, 32, "fma"),
        (torch.int8, 1280, 2048, 768, ValueError),
    ],
)
def test_gmm_bwd_tiling(dtype, C, D, F, want):
    if isinstance(want, str):
        assert gmm_bwd_tiling(dtype, C, D, F) == want
    else:
        with pytest.raises(want):
            gmm_bwd_tiling(dtype, C, D, F)


# ---------------------------------------------------------------------------
# (e) AdamW steps of qwen3-moe's smoke config through both train steps
# ---------------------------------------------------------------------------


def test_adamw_steps_of_the_moe_smoke_config_match_reference():
    """Three AdamW (WSD) steps of qwen3-moe's smoke config in fp32, remat
    "full", loss chunk 8, on the same weights (``params_from_jax``) and the
    same batches: loss, xent, aux and grad norm at rtol 1e-5 each step."""
    over = dict(param_dtype="float32", activation_dtype="float32")
    jcfg = dataclasses.replace(jbase.get_config(ARCH).smoke(), **over)
    tcfg = dataclasses.replace(tbase.get_config(ARCH).smoke(), **over)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    model = lm.init(0, tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    jopt, topt = jadamw(jwsd(1e-3, 10)), adamw(wsd(1e-3, 10))
    jstep = jax.jit(jmake_train_step(jcfg, jopt, ShardingPlan(fsdp=False, remat="full",
                                                              loss_chunk=8)))
    tstep = make_train_step(tcfg, topt, remat="full", loss_chunk=8)
    jstate = jopt.init(jparams)
    tstate = topt.init(dict(model.named_parameters()))
    spec = DataSpec(cfg=tcfg, shape=tbase.ShapeSpec("t", 20, 2, "train"), seed=1)
    losses = []
    for step in range(3):
        batch = batch_for_step(spec, step)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    jnp.int32(step))
        _, _, tm = tstep(model, tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                         step)
        for key in ("loss", "xent", "aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
        losses.append(float(tm["loss"]))
    assert all(np.isfinite(losses))
