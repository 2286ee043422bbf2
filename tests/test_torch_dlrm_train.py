"""The port's DLRM training slice against the JAX package: the lookup's
gradient (``ref_embedding_bag_bwd``, the backward kernel's plain version)
against ``jax.grad`` of the reference's gather, ids outside the table
included; ``models.dlrm``'s loss and every gradient against
``jax.value_and_grad`` of ``repro.models.dlrm.loss_fn``; ``train_dlrm``
against the step of ``examples/dlrm_testbed.py`` on the same batches; the
testbed twin's network table against the example's; AdamW's sliced update
of a huge leaf; and the backward wrapper's refusals and bookkeeping."""

import dataclasses
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.kernels import ref as jref
from repro.models import dlrm as jdlrm
from repro_torch.kernels import _build, ops
from repro_torch.kernels.embedding_bag import (
    EmbeddingBagFn, embedding_bag_bwd, key_dtype, sorted_keys,
)
from repro_torch.kernels.ref import ref_embedding_bag, ref_embedding_bag_bwd
from repro_torch.launch import dlrm_testbed
from repro_torch.models import dlrm
from repro_torch.optim import adamw, constant
from repro_torch.weights import dlrm_params_from_jax

torch.set_num_threads(2)  # several test processes share the cores

# The module: the package's `adamw` is the function.
adamw_mod = importlib.import_module("repro_torch.optim.adamw")

ROOT = Path(__file__).resolve().parents[1]
T, R, E, B = 3, 100, 16, 6
# tests/test_dlrm_model.py:11, as test_torch_dlrm.py takes it.
CFG = jdlrm.DLRMConfig(n_tables=4, rows_per_table=100, embed_dim=16,
                       dense_features=13, bottom_mlp=(32, 16), top_mlp=(32, 1))
TCFG = dlrm.DLRMConfig(**dataclasses.asdict(CFG))
REL = 1e-5  # fp32: every leaf within 1e-5 of its largest entry


def _ids(rng, kind, nnz, id_dtype):
    """(B, T, nnz) ids: uniform in [0, R); drawn from 8 of the R rows, so
    rows repeat; or from [-2R, 2R), so some lie past the table, some wrap
    and some wrap to below 0 (the last two kinds dropped by the gradient)."""
    if kind == "uniform":
        ids = rng.integers(0, R, (B, T, nnz))
    elif kind == "duplicates":
        ids = rng.choice(rng.choice(R, 8, replace=False), (B, T, nnz))
    else:
        ids = rng.integers(-2 * R, 2 * R, (B, T, nnz))
    return ids.astype(id_dtype)


def _jax_bag_grad(ids, dout):
    """``jax.grad`` of the reference's lookup at cotangent ``dout`` (fp32)."""
    f = lambda t: jref.ref_embedding_bag(t, jnp.asarray(ids))  # noqa: E731
    _, vjp = jax.vjp(f, jnp.zeros((T, R, E), jnp.float32))
    return np.asarray(vjp(jnp.asarray(dout))[0])


def _longest_run(ids):
    """The most (b, j) entries that add into one row."""
    keys = np.where(ids < 0, ids + R, ids) + np.arange(T)[None, :, None] * R
    return int(np.unique(keys, return_counts=True)[1].max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", ["uniform", "duplicates", "out_of_range"])
@pytest.mark.parametrize("nnz", [1, 4])
def test_ref_embedding_bag_bwd_matches_jax_grad(nnz, kind, id_dtype, dtype):
    """fp32: rtol 1e-6 and (the longest run) ulps of max|dout|, the sums
    running in another order; bf16: 2e-2 (dout and dtables rounded)."""
    rng = np.random.default_rng(nnz * 10 + len(kind))
    ids = _ids(rng, kind, nnz, id_dtype)
    dout = torch.from_numpy(rng.standard_normal((B, T, E)).astype(np.float32)).to(dtype)
    got = ref_embedding_bag_bwd(dout, torch.from_numpy(ids), R, dtype)
    assert got.dtype == dtype and got.shape == (T, R, E)
    want = _jax_bag_grad(ids, dout.float().numpy())
    if dtype == torch.float32:
        atol = _longest_run(ids) * np.finfo(np.float32).eps * float(dout.abs().max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_ref_embedding_bag_bwd_drops_ids_as_jax_grad_does():
    """R = 5: -1 wraps to row 4, -5 to row 0; 7, 5, -9 (wraps to -4) and -6
    (to -1) get no gradient, though the forward reads a clamped row for each."""
    raw = np.array([7, -1, -9, 5, -5, -6, 0, 4], np.int32)
    ids = torch.from_numpy(np.repeat(raw[:, None, None], 2, axis=1))  # (8, 2, 1)
    dout = torch.ones(8, 2, 3)
    got = ref_embedding_bag_bwd(dout, ids, 5, torch.float32)
    assert got[:, :, 0].tolist() == [[2.0, 0.0, 0.0, 0.0, 2.0]] * 2
    f = lambda t: jref.ref_embedding_bag(t, jnp.asarray(ids.numpy()))  # noqa: E731
    _, vjp = jax.vjp(f, jnp.zeros((2, 5, 3), jnp.float32))
    ct = jnp.ones((8, 2, 3), jnp.float32)  # float32 whatever jax_enable_x64 says
    np.testing.assert_array_equal(got.numpy(), np.asarray(vjp(ct)[0]))


def _kernel_walk(keys, pos, dout, nnz, n_rows, dtype):
    """The backward kernel's algorithm in NumPy: a run of equal sorted keys
    starts where the key changes; its dout rows are summed in fp32 in sorted
    order and written once, rounded."""
    keys, pos = keys.numpy(), pos.numpy()
    d = dout.float().numpy().reshape(-1, dout.shape[-1])  # row b * T + t
    out = np.zeros((n_rows, dout.shape[-1]), np.float32)
    for i, key in enumerate(keys):
        if key >= n_rows or (i > 0 and keys[i - 1] == key):
            continue
        acc = np.zeros(dout.shape[-1], np.float32)
        k = i
        while k < len(keys) and keys[k] == key:
            acc += d[pos[k] // nnz]
            k += 1
        out[key] = acc
    return torch.from_numpy(out).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["duplicates", "out_of_range"])
def test_sorted_keys_feed_the_kernels_walk_to_the_plain_sums_bitwise(kind, dtype):
    """``sorted_keys`` (the wrapper's bookkeeping) orders one row's entries in
    (b, j) order and keys dropped ids past every row, so the kernel's walk
    over them gives the plain version's bits."""
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(_ids(rng, kind, 5, np.int64))
    dout = torch.from_numpy(rng.standard_normal((B, T, E)).astype(np.float32)).to(dtype)
    keys, pos = sorted_keys(ids, R)
    assert keys.dtype == key_dtype(T, R) and pos.dtype == torch.int64
    assert keys.shape == (ids.numel(),)
    assert bool((keys[1:] >= keys[:-1]).all())
    same = keys[1:] == keys[:-1]
    assert bool((pos[1:][same] > pos[:-1][same]).all())  # stable: (b, j) order in a run
    wrapped = torch.where(ids < 0, ids + R, ids)
    assert int((keys == T * R).sum()) == int(((wrapped < 0) | (wrapped >= R)).sum())
    walked = _kernel_walk(keys, pos, dout, 5, T * R, dtype).view(T, R, E)
    assert torch.equal(walked, ref_embedding_bag_bwd(dout, ids, R, dtype))


@pytest.mark.parametrize("devices", [("cpu", "cpu"), ("cpu", "meta"), ("meta", "cpu")])
def test_bwd_wrapper_refuses_cpu_and_mixed_devices(devices, monkeypatch):
    """The CUDA backward never computes off the card, and raises before any build."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    dout = torch.zeros(3, 2, 8, device=devices[0])
    ids = torch.zeros(3, 2, 1, dtype=torch.int32, device=devices[1])
    with pytest.raises(ValueError, match="one CUDA device"):
        embedding_bag_bwd(dout, ids, 10, torch.float32)


@pytest.mark.parametrize("kind", ["uniform", "out_of_range"])
def test_ops_bag_lookup_under_grad_on_cpu_is_the_plain_function(kind, monkeypatch):
    """Under grad on the CPU the lookup goes through ``EmbeddingBagFn`` on the
    plain versions: the forward's sums, the plain backward's gradient (ids
    outside the table dropped), no launch counted, nothing built; and it
    saves the ids, never the tables."""
    monkeypatch.setattr(ops, "bag_lookup_launches", 0)
    monkeypatch.setattr(ops, "bag_lookup_bwd_launches", 0)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(_ids(rng, kind, 3, np.int32))
    tables = torch.from_numpy(rng.standard_normal((T, R, E)).astype(np.float32))
    leaf = tables.clone().requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = ops.bag_lookup(leaf, ids)
    assert [t.dtype for t in saved] == [torch.int32]  # the ids alone
    assert out.grad_fn is not None and torch.equal(out, ref_embedding_bag(tables, ids))
    dout = torch.from_numpy(rng.standard_normal((B, T, E)).astype(np.float32))
    (grad,) = torch.autograd.grad(out, leaf, dout)
    assert torch.equal(grad, ref_embedding_bag_bwd(dout, ids, R, torch.float32))
    assert ops.bag_lookup_launches == ops.bag_lookup_bwd_launches == 0
    with torch.no_grad():
        assert ops.bag_lookup(leaf, ids).grad_fn is None


def _jax_params(seed=0, cfg=CFG):
    return jdlrm.init(jax.random.PRNGKey(seed), cfg)


def _port_model(jparams, cfg):
    model = dlrm.init(0, cfg, device="cpu")
    model.load_state_dict(dlrm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return model


def _leaf_errs(got: dict, want: dict) -> dict:
    """max|got - want| / max|want| for each leaf."""
    return {n: float(np.abs(got[n] - w).max()) / max(float(np.abs(w).max()), 1e-30)
            for n, w in want.items()}


def _flat_jax(tree) -> dict:
    """The reference's pytree of parameters (or gradients) under the port's names."""
    out = {"tables": np.asarray(tree["tables"])}
    for name in ("bottom", "top"):
        for i, lyr in enumerate(tree[name]):
            out[f"{name}.{i}.w"], out[f"{name}.{i}.b"] = np.asarray(lyr["w"]), np.asarray(lyr["b"])
    return out


@pytest.mark.parametrize("ids", ["in_range", "past_and_negative"])
def test_loss_and_every_gradient_match_jax_value_and_grad(ids):
    """The port's DLRM loss and each leaf's gradient within 1e-5 of its max of
    ``jax.value_and_grad(repro.models.dlrm.loss_fn)``, with ids past the
    table, negative ids that wrap, and negative ids that wrap to below 0,
    whose gradients ``jax.grad`` drops."""
    jparams = _jax_params(1)
    model = _port_model(jparams, TCFG)
    rng = np.random.default_rng(11)
    Rt = CFG.rows_per_table
    lo, hi = (0, Rt) if ids == "in_range" else (-2 * Rt, 2 * Rt)
    sparse = rng.integers(lo, hi, (64, CFG.n_tables)).astype(np.int32)
    if ids != "in_range":
        sparse[:4] = [[Rt, -1, Rt + 3, -Rt - 7]] * 4
    batch = {"dense": rng.standard_normal((64, CFG.dense_features)).astype(np.float32),
             "sparse": sparse, "label": (sparse[:, 0] % 2).astype(np.float32)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jdlrm.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, CFG),
        has_aux=True)(jparams)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, aux = dlrm.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, TCFG)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    assert float(aux["bce"].detach()) == float(loss.detach())
    errs = _leaf_errs({n: g.numpy() for n, g in zip(params, grads)}, _flat_jax(jgrads))
    assert max(errs.values()) <= REL, errs


def _jax_example_run(steps: int, keep_after: int):
    """``examples/dlrm_testbed.py``'s training, step for step: its config,
    init, optimizer, jitted step and batches; returns the losses and the
    parameters after ``keep_after`` steps."""
    cfg = jdlrm.DLRMConfig(n_tables=8, rows_per_table=512, embed_dim=32)
    params = jdlrm.init(jax.random.PRNGKey(0), cfg)
    opt = jopt.adamw(jopt.constant(3e-3), weight_decay=0.0)
    state = opt.init(params)
    rng = np.random.default_rng(0)

    @jax.jit
    def step(p, s, batch, i):
        (l, _), g = jax.value_and_grad(lambda pp: jdlrm.loss_fn(pp, batch, cfg), has_aux=True)(p)
        p2, s2 = opt.update(g, s, p, i)
        return p2, s2, l

    losses, kept = [], None
    for i in range(steps):
        sparse = rng.integers(0, cfg.rows_per_table, (128, cfg.n_tables))
        batch = {
            "dense": jnp.array(rng.standard_normal((128, cfg.dense_features)), jnp.float32),
            "sparse": jnp.array(sparse, jnp.int32),
            "label": jnp.array(sparse[:, 0] % 2, jnp.float32),
        }
        params, state, loss = step(params, state, batch, jnp.int32(i))
        losses.append(float(loss))
        if i + 1 == keep_after:
            kept = _flat_jax(params)
    return losses, kept


# AdamW's update g / (|g| + 1e-8) turns a gradient entry within rounding of 0
# into a step that differs in the first digits: bottom.0.w[9, 54] has a
# first gradient of -1.69e-9 here and -1.91e-9 in JAX (6e-7 of the leaf's
# max|g|), which moves it 4.7e-5 apart (8.6e-5 of the leaf's max) after 3
# steps, while every other entry of every leaf agrees within 1e-5.
PARAM_REL = 1e-4


def test_train_dlrm_follows_the_examples_jitted_step(monkeypatch):
    """``train_dlrm`` at the example's config, from the example's initial
    parameters, on the same batches: the first 5 losses within rtol 1e-5,
    and every parameter after 3 steps within PARAM_REL of its leaf's max."""
    jlosses, jparams3 = _jax_example_run(5, keep_after=3)
    cfg = dlrm_testbed.SMALL_CFG
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jdlrm.DLRMConfig(n_tables=8, rows_per_table=512, embed_dim=32))
    start = jax.tree.map(np.asarray, jdlrm.init(jax.random.PRNGKey(0), jdlrm.DLRMConfig(
        n_tables=8, rows_per_table=512, embed_dim=32)))
    real_init = dlrm.init

    def init_from_jax(seed, cfg, device=None):
        model = real_init(seed, cfg, device=device)
        model.load_state_dict(dlrm_params_from_jax(start, cfg))
        return model

    monkeypatch.setattr(dlrm, "init", init_from_jax)
    args = (cfg, dlrm_testbed.SMALL_BATCH, dlrm_testbed.SMALL_LR)
    run5 = dlrm_testbed.train_dlrm(args[0], 5, *args[1:], seed=0, device="cpu")
    np.testing.assert_allclose(run5.losses, jlosses, rtol=1e-5)
    assert run5.step_s == []  # no timings off the card
    run3 = dlrm_testbed.train_dlrm(args[0], 3, *args[1:], seed=0, device="cpu")
    got = {n: p.detach().numpy() for n, p in run3.model.named_parameters()}
    errs = _leaf_errs(got, jparams3)
    assert max(errs.values()) <= PARAM_REL, errs


def test_train_small_dlrm_learns_as_the_example_requires(capsys):
    final = dlrm_testbed.train_small_dlrm(80, device="cpu")
    assert final < 0.6
    line = capsys.readouterr().out.strip()
    assert line.startswith("DLRM training: loss ") and line.endswith(f"{final:.4f}")


def _example_module():
    spec = importlib.util.spec_from_file_location(
        "dlrm_testbed_example", ROOT / "examples" / "dlrm_testbed.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_network_study_prints_the_examples_table(capsys):
    """The table from the port's planner (host NumPy) equals the example's,
    text for text."""
    _example_module().network_study()
    want = capsys.readouterr().out
    dlrm_testbed.network_study()
    got = capsys.readouterr().out
    assert got == want
    assert len(got.strip().splitlines()) == 6  # title, header, 4 batch sizes


def test_main_trains_then_prints_the_table_on_cpu(capsys):
    dlrm_testbed.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("DLRM training: loss ") and "Fig. 21 style" in out[2]
    assert len(out) == 8


@pytest.mark.parametrize("entry", ["train_dlrm", "main"])
def test_entry_points_need_a_card_unless_given_the_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "train_dlrm":
            dlrm_testbed.train_dlrm(TCFG, 1, 8, 1e-3)
        else:
            dlrm_testbed.main([])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_updates_a_huge_leaf_in_slices_bitwise(dtype, monkeypatch):
    """With the slice at 7 elements, a (3, 10, 4) leaf updates in 18 slices
    (the last ragged) and a (5,) leaf whole: two steps give the same bits as
    the whole-leaf update, parameters, masters and moments."""
    rng = np.random.default_rng(5)
    shapes = {"big": (3, 10, 4), "small": (5,)}
    params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
              for n, s in shapes.items()}
    grads = [{n: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
              for n, s in shapes.items()} for _ in range(2)]
    opt = adamw(constant(1e-2), weight_decay=0.1)

    def run():
        ps = {n: p.clone() for n, p in params.items()}
        state = opt.init(ps)
        for i, g in enumerate(grads):
            opt.update(g, state, ps, i)
        return ps, state

    whole_p, whole_s = run()
    monkeypatch.setattr(adamw_mod, "SLICE_ELEMENTS", 7)
    sliced_p, sliced_s = run()
    for n in shapes:
        assert torch.equal(sliced_p[n], whole_p[n])
        for group in whole_s:
            assert torch.equal(sliced_s[group][n], whole_s[group][n])
    assert not torch.equal(whole_p["big"], params["big"])


def test_embedding_bag_fn_gives_the_ids_no_gradient():
    tables = torch.randn(2, 10, 4, requires_grad=True)
    ids = torch.randint(0, 10, (3, 2, 2))
    out = EmbeddingBagFn.apply(tables, ids)
    out.sum().backward()
    assert tables.grad.shape == tables.shape and ids.grad is None
    assert torch.equal(tables.grad, ref_embedding_bag_bwd(torch.ones(3, 2, 4), ids, 10,
                                                          torch.float32))
