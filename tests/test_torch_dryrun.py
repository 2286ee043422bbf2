"""The port's dry run (``repro_torch.launch.dryrun``): each LM family's smoke
cells on a fake (2, 4) mesh through the kernels' fake implementations, as
``tests/test_system.py::test_dryrun_cell_smoke`` runs the reference's, with
the per-device FLOPs held between an eighth of the one-rank run's and the
whole of it and the kernel launches each family makes a layer; and the CLI
at full width in a process of its own."""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.kernels import _build
from repro_torch.launch.dryrun import dryrun_cell
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.parallel.sharding import ShardingPlan

torch.set_num_threads(2)  # several test processes share the cores

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"train": ShapeSpec("t", 64, 8, "train"), "prefill": ShapeSpec("p", 64, 8, "prefill"),
          "decode": ShapeSpec("d", 64, 8, "decode")}
FAMILIES = {"dense": "granite-8b", "moe": "qwen3-moe-30b-a3b", "ssm": "falcon-mamba-7b",
            "hybrid": "recurrentgemma-9b", "vlm": "llama-3.2-vision-11b",
            "audio": "hubert-xlarge"}
CELLS = [(f, k) for f in FAMILIES for k in SHAPES if not (f == "audio" and k == "decode")]
KERNELS = ("attention", "grouped_matmul", "selective_scan", "lru_scan")


def smoke(family: str):
    """The family's smoke config at head dim 64, the attention kernels' smallest."""
    return dataclasses.replace(get_config(FAMILIES[family]).smoke(), head_dim=64)


def want_launches(cfg, kind: str) -> dict:
    """The launches a step of ``cfg`` makes on the card: under remat "full"
    a trained layer runs its forward kernels twice and its backward once (a
    VLM cross layer, not rematerialized, once each way); prefill once; a
    decode step only the MoE's grouped matmuls (the attention and the scans
    take one plain step)."""
    if cfg.family == "hybrid":
        blocks = cfg.n_layers // len(cfg.block_pattern)
        kinds = list(cfg.block_pattern) * blocks + list(cfg.tail_pattern)
        rec, attn, cross = kinds.count("rec"), kinds.count("attn"), 0
    elif cfg.family == "ssm":
        rec, attn, cross = cfg.n_layers, 0, 0
    else:
        cross = cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every else 0
        rec, attn = 0, cfg.n_layers - cross
    scan = "lru_scan" if cfg.family == "hybrid" else "selective_scan"
    gmm = 3 * attn if cfg.family == "moe" else 0  # gate, up and down a layer
    if kind == "train":
        fwd = {"attention": 2 * attn + cross, scan: 2 * rec, "grouped_matmul": 2 * gmm}
        bwd = {"attention": attn + cross, scan: rec, "grouped_matmul": gmm}
    elif kind == "prefill":
        fwd, bwd = {"attention": attn + cross, scan: rec, "grouped_matmul": gmm}, {}
    else:
        fwd, bwd = {"grouped_matmul": gmm}, {}
    want = {f"{k}_launches": n for k, n in fwd.items() if n}
    want.update({f"{k}_bwd_launches": n for k, n in bwd.items() if n})
    return want


@contextlib.contextmanager
def fake_group(n: int):
    made = fake_world(n)
    try:
        yield
    finally:
        if made:
            dist.destroy_process_group()


def run_cell(cfg, kind: str, shape: tuple[int, int]) -> dict:
    with fake_group(math.prod(shape)):
        return dryrun_cell(cfg, SHAPES[kind], make_test_mesh(shape), ShardingPlan())


@pytest.mark.parametrize("family,kind", CELLS)
def test_dryrun_cell_smoke(family, kind):
    cfg = smoke(family)
    rec = run_cell(cfg, kind, (2, 4))
    r = rec["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["useful_fraction"] > 0 and math.isfinite(r["mfu"])
    assert rec["mesh"] == {"data": 2, "model": 4} and rec["chips"] == 8
    assert rec["memory"]["peak_size_in_bytes"] == (rec["memory"]["argument_size_in_bytes"]
                                                   + rec["memory"]["temp_size_in_bytes"])
    # Every head, expert, channel and row of the smoke cells divides the
    # mesh: splitting neither drops products nor gives a rank more than all.
    whole = run_cell(cfg, kind, (1, 1))
    assert whole["collectives"]["total_bytes"] == 0
    flops, all_flops = rec["hlo"]["flops_per_dev"], whole["hlo"]["flops_per_dev"]
    assert all_flops / 8 <= flops <= all_flops
    main = {n: c for n, c in rec["launches"].items()
            if n.removesuffix("_bwd_launches").removesuffix("_launches") in KERNELS}
    assert main == want_launches(cfg, kind)
    assert whole["launches"] == rec["launches"]
    assert not _build._LIBS and not dist.is_initialized()


def test_a_full_width_prefill_fits_the_card_on_the_single_pod():
    """granite-8b's prefill_32k on (16, 16): 2 prompts of 32768 tokens a data
    rank, its heads, columns and cache positions split 16 ways.  The step's
    own tensors (meta ones included) count toward the peak, so a global-size
    scratch tensor would show (the whole cache in fp32 is 155 GB)."""
    from repro_torch.configs.base import ALL_SHAPES
    from repro_torch.launch.mesh import make_production_mesh

    with fake_group(256):
        rec = dryrun_cell(get_config("granite-8b"), ALL_SHAPES[1], make_production_mesh(),
                          ShardingPlan())
    assert rec["shape"] == "prefill_32k"
    assert 0 < rec["memory"]["peak_size_in_bytes"] < 80e9
    assert rec["launches"]["attention_launches"] == 36


def test_import_joins_no_group_and_touches_no_card():
    code = ("import torch, torch.distributed as dist\n"
            "import repro_torch.launch.dryrun\n"
            "assert not dist.is_initialized() and not torch.cuda.is_initialized()\n"
            "print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "clean", proc.stderr


def test_cli_writes_a_full_width_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-8b",
         "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "dry-run complete: 1 ok, 0 skipped, 0 failed" in proc.stdout
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == ["granite-8b_decode_32k_single_pod_baseline.json"]
    rec = json.loads(files[0].read_text())
    assert {"arch", "shape", "mesh", "chips", "plan", "build_s", "step_s", "memory", "hlo",
            "collectives", "launches", "roofline", "mesh_name", "tag"} <= rec.keys()
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["chips"] == 256
    assert rec["roofline"]["chips"] == 256 and rec["roofline"]["model_flops"] > 0
