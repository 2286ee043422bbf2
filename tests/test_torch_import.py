"""The port stands alone: it imports neither JAX nor the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)  # several test processes share the cores

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""

# Modules each slice added; the walk above must reach every one of them.
SLICE_MODULES = (
    "repro_torch.models.transformer", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.moe_gmm", "repro_torch.models.recurrent",
    "repro_torch.kernels.mamba_scan", "repro_torch.kernels.rglru_scan",
    "repro_torch.models.dlrm", "repro_torch.kernels.embedding_bag",
    "repro_torch.optim.adamw", "repro_torch.optim.schedule", "repro_torch.data.pipeline",
    "repro_torch.checkpoint.ckpt", "repro_torch.train.steps", "repro_torch.train.loop",
    "repro_torch.launch.train", "repro_torch.launch.trace_train",
) + tuple(f"repro_torch.core.{m}" for m in (
    "totient", "select_perms", "routing", "demand", "topology_finder", "netsim", "planeval",
    "costmodel", "schedules", "workloads", "strategy_search", "planeval_torch",
    "ocs_reconfig", "simengine", "alternating",
)) + ("repro_torch.core",)


def test_port_imports_without_jax_and_without_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 25  # every module was reached
    walked = set(proc.stdout.splitlines()[-2].split())
    assert set(SLICE_MODULES) <= walked


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


def test_no_jax_or_repro_import_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(f.name, m) for f in files for m in _imported_modules(f) if _forbidden(m)]
    assert not bad


_IMPORT_CORE = """
import importlib, sys
from test_torch_import import SLICE_MODULES
core = [m for m in SLICE_MODULES if m.startswith("repro_torch.core")]
for name in core:
    importlib.import_module(name)
assert "jax" not in sys.modules, "jax was imported"
leaked = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
assert not leaked, leaked
print(len(core))
"""


def test_planner_core_imports_leave_jax_and_repro_out():
    """The planner (``repro_torch.core`` and its 15 modules) imports neither
    JAX nor the JAX package, not even the NumPy half it was forked from."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_CORE], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == 16
