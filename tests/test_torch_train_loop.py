"""The port's optimizers, schedules, data pipeline, checkpoints, training
loop and training CLI against the JAX package's, on the same numpy arrays."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import base as jbase
from repro.data import pipeline as jdata
from repro_torch import optim
from repro_torch.checkpoint.ckpt import (
    available_steps, latest_step, load_checkpoint, prune_checkpoints, save_checkpoint,
)
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import DataSpec, Prefetcher, batch_for_step
from repro_torch.models import lm
from repro_torch.train.loop import InjectedFailure, train

torch.set_num_threads(2)  # several test processes share the cores

ROOT = Path(__file__).resolve().parents[1]
SHAPE = tbase.ShapeSpec("tiny", seq_len=32, global_batch=4, kind="train")
QUIET = dict(log_every=100, logger=lambda *a: None, device="cpu")


# ---------------------------------------------------------------------------
# Schedules and optimizers, against the reference on the same arrays (1e-6)
# ---------------------------------------------------------------------------

SCHEDULES = [
    ("constant", (3e-3,), {}),
    ("linear_warmup", (3e-3, 10), {}),
    ("cosine", (3e-3, 100), {"warmup": 10}),
    ("cosine", (1.0, 50), {"warmup": 0, "final_frac": 0.0}),
    ("wsd", (3e-3, 1000), {}),
    ("wsd", (1.0, 14), {"warmup_frac": 0.2, "decay_frac": 0.5}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES)
def test_schedules_match_reference(name, args, kw):
    ours, ref = getattr(optim, name)(*args, **kw), getattr(jopt, name)(*args, **kw)
    for step in [0, 1, 2, 5, 9, 10, 11, 13, 49, 50, 99, 100, 500, 899, 900, 950, 999, 1000, 2000]:
        got = ours(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(ref(jnp.int32(step))), rtol=1e-6, atol=1e-12)


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 5)).astype(dtype),
            "b": rng.standard_normal((5,)).astype(dtype),
            "s": np.asarray(rng.standard_normal(), dtype)}


def _torch(tree, dtype):
    return {n: torch.from_numpy(np.array(a)).to(dtype) for n, a in tree.items()}


def _jax(tree, dtype):
    return {n: jnp.asarray(a, dtype) for n, a in tree.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("master", [True, False])
def test_adamw_updates_match_reference(pdtype, master):
    """Three AdamW(wsd) updates from the same parameters and gradients: the
    state (m, v, the fp32 master copy) within 1e-6; bf16 parameters within
    one bf16 ulp, since an fp32 value within 1e-6 can round to either
    neighbour."""
    tdt, jdt = getattr(torch, pdtype), getattr(jnp, pdtype)
    ours = optim.adamw(optim.wsd(1e-2, 10), master_fp32=master)
    ref = jopt.adamw(jopt.wsd(1e-2, 10), master_fp32=master)
    params, jparams = _torch(_tree(0), tdt), _jax(_tree(0), jdt)
    state, jstate = ours.init(params), ref.init(jparams)
    assert sorted(state) == sorted(jstate)
    if master and pdtype == "bfloat16":
        assert all(t.dtype == torch.float32 for t in state["master"].values())
    for step in range(3):
        grads = _tree(10 + step)
        ours.update(_torch(grads, tdt), state, params, step)
        jparams, jstate = ref.update(_jax(grads, jdt), jstate, jparams, jnp.int32(step))
    for name in params:
        for key in state:
            _close(state[key][name], jstate[key][name], rtol=1e-6, atol=1e-6)
        assert params[name].dtype == tdt
        ulp = 2.0 ** -7 if pdtype == "bfloat16" else 1e-6
        _close(params[name], jparams[name], rtol=ulp, atol=1e-6)


def test_adamw_fp32_parameter_is_its_own_master():
    """fp32 leaves keep no second copy: the master is the parameter."""
    params = _torch(_tree(1), torch.float32)
    state = optim.adamw(optim.constant(1e-3)).init(params)
    assert all(state["master"][n].data_ptr() == p.data_ptr() for n, p in params.items())
    optim.adamw(optim.constant(1e-3)).update(_torch(_tree(2), torch.float32), state, params, 0)
    assert all(torch.equal(state["master"][n], p) for n, p in params.items())


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_sgd_momentum_updates_match_reference(pdtype):
    tdt, jdt = getattr(torch, pdtype), getattr(jnp, pdtype)
    ours = optim.sgd_momentum(optim.cosine(0.1, 10, warmup=2))
    ref = jopt.sgd_momentum(jopt.cosine(0.1, 10, warmup=2))
    params, jparams = _torch(_tree(3), tdt), _jax(_tree(3), jdt)
    state, jstate = ours.init(params), ref.init(jparams)
    for step in range(3):
        grads = _tree(20 + step)
        ours.update(_torch(grads, tdt), state, params, step)
        jparams, jstate = ref.update(_jax(grads, jdt), jstate, jparams, jnp.int32(step))
    ulp = 2.0 ** -7 if pdtype == "bfloat16" else 1e-6
    for name in params:
        _close(state["mom"][name], jstate["mom"][name], rtol=1e-6, atol=1e-6)
        _close(params[name], jparams[name], rtol=ulp, atol=1e-6)


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(pdtype):
    tdt, jdt = getattr(torch, pdtype), getattr(jnp, pdtype)
    params, updates = _torch(_tree(4), tdt), _torch(_tree(5), torch.float32)
    want = jopt.apply_updates(_jax(_tree(4), jdt), _jax(_tree(5), jnp.float32))
    got = optim.apply_updates(params, updates)
    assert got is params
    for name in params:
        assert params[name].dtype == tdt
        _close(params[name], want[name], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Data pipeline: bitwise the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["minicpm-2b", "llama-3.2-vision-11b", "hubert-xlarge"])
@pytest.mark.parametrize("process", [(0, 1), (1, 2), (2, 3)])
def test_batch_for_step_is_bitwise_the_reference(arch, process):
    jcfg, tcfg = jbase.get_config(arch).smoke(), tbase.get_config(arch).smoke()
    jshape = jbase.ShapeSpec("tiny", 16, 5, "train")
    tshape = tbase.ShapeSpec("tiny", 16, 5, "train")
    jspec = jdata.DataSpec(cfg=jcfg, shape=jshape, seed=3, process_index=process[0],
                           process_count=process[1])
    tspec = DataSpec(cfg=tcfg, shape=tshape, seed=3, process_index=process[0],
                     process_count=process[1])
    for step in (0, 1, 17):
        got, want = batch_for_step(tspec, step), jdata.batch_for_step(jspec, step)
        assert sorted(got) == sorted(want)
        for key in got:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_prefetcher_hands_out_the_reference_stream_in_order():
    cfg = tbase.get_config("minicpm-2b").smoke()
    jspec = jdata.DataSpec(cfg=jbase.get_config("minicpm-2b").smoke(),
                           shape=jbase.ShapeSpec("tiny", 32, 4, "train"), seed=2)
    pf = Prefetcher(DataSpec(cfg=cfg, shape=SHAPE, seed=2), start_step=5, depth=2)
    try:
        for expect in (5, 6, 7, 8):
            step, batch = pf.next()
            assert step == expect
            np.testing.assert_array_equal(batch["tokens"],
                                          jdata.batch_for_step(jspec, expect)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _state():
    gen = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn(6, 4, generator=gen).to(torch.bfloat16),
              "blocks.0.w": torch.randn(4, 4, generator=gen),
              "gate": torch.tensor(0.5)}
    opt = optim.adamw(optim.constant(1e-3)).init(params)
    opt["m"]["embed"].normal_(generator=gen)
    return params, opt


def test_checkpoint_round_trip_keeps_values_and_dtypes(tmp_path):
    params, opt = _state()
    path = save_checkpoint(str(tmp_path), 7, params, opt, extra={"note": "x"})
    assert os.path.basename(path) == "step-00000007"
    assert sorted(os.listdir(path)) == ["manifest.json", "opt_state.npz", "params.npz"]
    with np.load(os.path.join(path, "params.npz")) as z:
        assert "embed::bfloat16" in z.files and z["embed::bfloat16"].dtype == np.uint16
    specs = {n: torch.zeros_like(t) for n, t in params.items()}
    opt_specs = {g: {n: torch.zeros_like(t) for n, t in grp.items()} for g, grp in opt.items()}
    step, got, got_opt, manifest = load_checkpoint(str(tmp_path), specs, opt_specs, device="cpu")
    assert step == 7 and manifest["note"] == "x" and manifest["has_opt_state"]
    for name, t in params.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t)
    for group, tree in opt.items():
        for name, t in tree.items():
            assert torch.equal(got_opt[group][name], t)


def test_checkpoint_prune_keeps_the_latest_and_leaves_no_staging(tmp_path):
    params, opt = _state()
    for step in (2, 4, 6, 8, 10):
        save_checkpoint(str(tmp_path), step, params, opt)
    assert available_steps(str(tmp_path)) == [2, 4, 6, 8, 10]
    prune_checkpoints(str(tmp_path), keep=3)
    assert available_steps(str(tmp_path)) == [6, 8, 10]
    assert latest_step(str(tmp_path)) == 10
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".staging")]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    params, _ = _state()
    save_checkpoint(str(tmp_path), 1, params)
    specs = {n: torch.zeros_like(t) for n, t in params.items()}
    specs["blocks.0.w"] = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="blocks.0.w"):
        load_checkpoint(str(tmp_path), specs)


def test_checkpoint_missing_raises_and_params_only_loads(tmp_path):
    params, _ = _state()
    specs = {n: torch.zeros_like(t) for n, t in params.items()}
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), specs)
    assert latest_step(str(tmp_path / "none")) is None
    save_checkpoint(str(tmp_path), 3, params)
    step, got, got_opt, manifest = load_checkpoint(str(tmp_path), specs, specs)
    assert step == 3 and got_opt is None and not manifest["has_opt_state"]


# ---------------------------------------------------------------------------
# The loop and the CLI
# ---------------------------------------------------------------------------

SMOKE = tbase.get_config("minicpm-2b").smoke()


def test_loop_loss_decreases():
    res = train(SMOKE, SHAPE, optim.adamw(optim.cosine(3e-3, 60, warmup=3)), total_steps=25,
                **QUIET)
    assert res.final_step == 25 and len(res.losses) == 25
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])


def test_loop_failure_injection_and_resume_is_bitwise(tmp_path):
    cfg = dataclasses.replace(SMOKE, n_layers=2)
    opt = optim.adamw(optim.wsd(1e-3, 12))
    whole = train(cfg, SHAPE, opt, total_steps=12, ckpt_dir=str(tmp_path / "whole"), **QUIET)
    with pytest.raises(InjectedFailure):
        train(cfg, SHAPE, opt, total_steps=12, ckpt_dir=str(tmp_path / "run"), ckpt_every=3,
              fail_at=7, **QUIET)
    assert latest_step(str(tmp_path / "run")) == 6  # the last periodic save before the failure
    res = train(cfg, SHAPE, opt, total_steps=12, ckpt_dir=str(tmp_path / "run"), ckpt_every=3,
                **QUIET)
    assert res.final_step == 12 and len(res.losses) == 6  # steps 6..11 only
    assert res.losses == whole.losses[6:]
    assert latest_step(str(tmp_path / "run")) == 12
    specs = dict(lm.init(0, cfg, device="cpu").named_parameters())
    _, a, _, _ = load_checkpoint(str(tmp_path / "run"), specs)
    _, b, _, _ = load_checkpoint(str(tmp_path / "whole"), specs)
    assert all(torch.equal(a[n], b[n]) for n in specs)


def test_loop_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(SMOKE, SHAPE, optim.adamw(optim.constant(1e-3)), total_steps=1,
              logger=lambda *a: None)


def test_train_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "minicpm-2b", "--smoke",
         "--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path), "--loss-chunk", "16"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "done: step=3" in proc.stdout
    assert latest_step(str(tmp_path)) == 3
