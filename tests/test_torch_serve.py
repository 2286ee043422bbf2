"""The port's serving CLI: runs on the CPU only when asked to."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import serve
from repro_torch.models import lm

torch.set_num_threads(2)  # several test processes share the cores

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--arch", "granite-8b", "--smoke", "--batch", "2", "--prompt-len", "8",
         "--decode-steps", "4"]


def test_main_on_cpu_prints_its_lines(capsys):
    serve.main([*SMOKE, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu (host clock; not a device time)"
    assert out[1].startswith("prefill: 2x8 in ") and out[1].endswith("not a device time)")
    assert out[2].startswith("decode: 4 steps in ") and "ms/token" in out[2]
    assert out[3].startswith("generated ids (first seq):")


def test_main_serves_the_moe_family_on_cpu(capsys):
    args = [a if a != "granite-8b" else "qwen3-moe-30b-a3b" for a in SMOKE]
    serve.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("prefill: 2x8 in ")
    assert out[3].startswith("generated ids (first seq):")


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_main_serves_the_recurrent_families_on_cpu(capsys, arch):
    args = [a if a != "granite-8b" else arch for a in SMOKE]
    serve.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("prefill: 2x8 in ")
    assert out[3].startswith("generated ids (first seq):")


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SMOKE)
    for arch in ("granite-8b", "falcon-mamba-7b", "recurrentgemma-9b", "llama-3.2-vision-11b",
                 "hubert-xlarge"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm.init(0, get_config(arch).smoke())


def test_generate_starts_from_prefill_argmax():
    cfg = get_config("granite-8b").smoke()
    model = lm.init(5, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 10), generator=torch.Generator().manual_seed(5))
    timings = {}
    out = serve.generate(model, tokens, 5, timings)
    assert out.shape == (3, 5) and out.dtype == torch.int64
    logits, _ = lm.prefill(model, {"tokens": tokens}, cfg)
    torch.testing.assert_close(out[:, 0], logits.argmax(-1))
    assert timings["prefill_s"] > 0 and timings["decode_s"] > 0


def test_script_runs_as_a_file():
    """``python src/repro_torch/launch/serve.py`` finds its package by itself."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # several test processes share the cores
    proc = subprocess.run(
        [sys.executable, str(ROOT / "src" / "repro_torch" / "launch" / "serve.py"),
         *SMOKE, "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "generated ids" in proc.stdout
