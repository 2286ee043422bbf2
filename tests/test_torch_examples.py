"""The port's twins of ``examples/quickstart.py`` and ``examples/serve_decode.py``
against the examples themselves, on the CPU.

The quickstart twin under ``backend="numpy"`` (the host walk, which equals
the JAX package's default backend to the bit) prints the example's text
line for line.  The serve_decode twin's greedy ids over 8 steps, on the
JAX package's smoke weights (copied in with ``params_from_jax``) in fp32,
equal those of the example's prefill and decode loop on the same numpy
prompts.  Both twins run on the card unless told otherwise, and raise
without one.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.configs.base import get_config
from repro_torch.launch import quickstart, serve_decode
from repro_torch.models import lm
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
