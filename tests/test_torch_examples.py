"""The port's twins of ``examples/quickstart.py``, ``examples/serve_decode.py``
and ``examples/train_lm_topoopt.py`` against the examples themselves, on the
CPU.

The quickstart twin under ``backend="numpy"`` (the host walk, which equals
the JAX package's default backend to the bit) prints the example's text
line for line.  The serve_decode twin's greedy ids over 8 steps, on the
JAX package's smoke weights (copied in with ``params_from_jax``) in fp32,
equal those of the example's prefill and decode loop on the same numpy
prompts.  The train_lm_topoopt twin on 8 gloo ranks under
``torch.distributed.run`` prints the example's plan lines, and its final
loss is within rtol 1e-4 of the example's on 8 forced host devices: both
start from the example's weights (``PRNGKey(0)``), which the test hands the
twin as a step-0 checkpoint, its own way to resume.  The twins run on the
card unless told otherwise, and raise without one.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.configs.base import get_config
from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.launch import quickstart, serve_decode, train_lm_topoopt
from repro_torch.models import lm
from repro_torch.optim import adamw, cosine
from repro_torch.weights import params_from_jax

torch.set_num_threads(2)  # several test processes share the cores

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_prints_the_examples_text(capsys):
    _example("quickstart").main()
    want = capsys.readouterr().out
    quickstart.main(backend="numpy")
    got = capsys.readouterr().out
    assert got == want
    assert "strategy: " in got and "vs similar-cost fat-tree" in got


def test_quickstart_twin_plans_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main()


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activation_dtype="float32")


def _jax_loop(jparams, jcfg, batch, prompt_len, decode_steps):
    """The example's prefill and decode loop (``examples/serve_decode.py``) on
    its numpy prompts -> greedy ids (batch, decode_steps)."""
    rng = np.random.default_rng(0)
    b = {"tokens": jnp.array(rng.integers(0, jcfg.vocab, (batch, prompt_len)), jnp.int32)}
    if jcfg.family == "vlm":
        b["image_embeds"] = jnp.array(
            rng.standard_normal((batch, jcfg.img_tokens, jcfg.d_model)),
            jnp.dtype(jcfg.activation_dtype))
    prefill = jax.jit(lambda p, x: jlm.prefill(p, x, jcfg, pad_to=prompt_len + decode_steps))
    decode = jax.jit(lambda p, x: jlm.decode_step(p, x, jcfg))
    logits, cache = prefill(jparams, b)
    tok = jnp.argmax(logits, axis=-1)
    ids = [tok]
    for i in range(decode_steps - 1):
        logits, cache = decode(
            jparams, {"token": tok, "pos": jnp.int32(prompt_len + i), "cache": cache})
        tok = jnp.argmax(logits, axis=-1)
        ids.append(tok)
    return np.stack([np.asarray(t) for t in ids], axis=1)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "falcon-mamba-7b", "granite-8b"])
def test_serve_decode_twin_ids_match_the_examples_loop(arch):
    """8 greedy steps (the prefill's and 7 decode steps) of 2 prompts of 20
    tokens, on the same fp32 weights: the same ids."""
    jcfg, tcfg = _fp32(jget_config(arch).smoke()), _fp32(get_config(arch).smoke())
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    model = lm.init(0, tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    ids, n_tokens, seconds = serve_decode.serve(model, 2, 20, 8)
    assert ids.shape == (2, 8) and n_tokens == 2 * 7 and seconds > 0
    np.testing.assert_array_equal(ids, _jax_loop(jparams, jcfg, 2, 20, 8))


def test_serve_decode_twin_prints_the_examples_line_on_cpu(capsys):
    serve_decode.main(["--device", "cpu", "--batch", "2", "--prompt-len", "12",
                       "--decode-steps", "4"])
    line = capsys.readouterr().out.strip()
    assert line.startswith("recurrentgemma-9b (smoke): 6 tokens in ")
    assert line.endswith(" tok/s (batch 2)")


@pytest.mark.parametrize("argv", [["--device", "cuda"], []])
def test_serve_decode_twin_needs_a_card_unless_given_the_cpu(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_decode.main(argv)


TOPOOPT_ARGS = ["--steps", "3", "--d-model", "64", "--n-layers", "2"]


def _run(cmd, env, timeout=300):
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _lines(out: str) -> dict:
    """The printed lines by their first words."""
    got = {}
    for line in out.splitlines():
        for key in ("model:", "TotientPerms ring strides:", "resumed from step", "final loss:"):
            if line.startswith(key):
                got[key] = line
    return got


def test_train_lm_topoopt_twin_on_8_gloo_ranks_matches_the_example(tmp_path):
    """The example on 8 forced host devices and the twin on 8 gloo ranks,
    ``--steps 3 --d-model 64 --n-layers 2``, from the same weights: the same
    model and ring-stride lines, and final losses within rtol 1e-4."""
    over = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=4, head_dim=32, d_ff=256,
                vocab=32768, param_dtype="float32", activation_dtype="float32")
    jcfg = dataclasses.replace(jget_config("granite-8b"), **over)
    tcfg = dataclasses.replace(get_config("granite-8b"), **over)
    model = lm.init(0, tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg)), tcfg))
    params = dict(model.named_parameters())
    save_checkpoint(str(tmp_path), 0, params, adamw(cosine(3e-3, 3)).init(params))

    src = str(ROOT / "src")
    jenv = dict(os.environ, PYTHONPATH=src, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    tenv = dict(os.environ, PYTHONPATH=src)
    with ThreadPoolExecutor(1) as pool:  # the example runs beside the twin's ranks
        example = pool.submit(_run, [sys.executable, "examples/train_lm_topoopt.py",
                                     *TOPOOPT_ARGS], jenv)
        twin = _lines(_run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", "8", "-m", "repro_torch.launch.train_lm_topoopt",
                            "--device", "cpu", "--ckpt-dir", str(tmp_path), *TOPOOPT_ARGS], tenv))
        want = _lines(example.result())
    assert twin["model:"] == want["model:"] == "model: 4.4M params on 8 devices"
    assert twin["TotientPerms ring strides:"] == want["TotientPerms ring strides:"]
    assert twin["resumed from step"] == "resumed from step 0"
    got_loss = float(twin["final loss:"].split()[-1])
    want_loss = float(want["final loss:"].split()[-1])
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)


@pytest.mark.parametrize("argv", [["--device", "cuda"], []])
def test_train_lm_topoopt_twin_needs_a_card_unless_given_the_cpu(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm_topoopt.main(argv)


def test_train_lm_topoopt_twin_trains_and_resumes_on_one_cpu_rank(tmp_path, capsys):
    """World size 1 without torch.distributed.run's environment: 50 steps
    write a checkpoint, and a second run of 52 resumes from it."""
    args = ["--device", "cpu", "--d-model", "32", "--n-layers", "1", "--ckpt-dir",
            str(tmp_path)]
    train_lm_topoopt.main(["--steps", "50", *args])
    first = _lines(capsys.readouterr().out)
    assert first["model:"].endswith("on 1 devices")
    assert first["TotientPerms ring strides:"] == "TotientPerms ring strides: ()"
    train_lm_topoopt.main(["--steps", "52", *args])
    again = _lines(capsys.readouterr().out)
    assert again["resumed from step"] == "resumed from step 50"
    assert np.isfinite(float(again["final loss:"].split()[-1]))
