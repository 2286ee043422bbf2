"""Runs a job of the port on several gloo ranks on the CPU, one process a rank.

``launch(job, world, tmp_path, inputs)`` pickles ``inputs``, starts ``world``
copies of this file (``python _torch_ranks.py JOB RANK WORLD DIR``), each of
which joins a gloo process group through a file in ``DIR`` (no TCP port to
collide with other test processes), runs ``JOBS[job](rank, inputs)`` and
pickles its result; it returns the results by rank.  A rank that hangs
fails its collective after ``PG_TIMEOUT`` seconds, and the launch kills
every rank after ``timeout``.  This module imports neither JAX nor the JAX
package: the jobs run the port alone.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PG_TIMEOUT = 120  # seconds a rank waits for its peers, then fails

# The collective schedules held to the JAX package: (name, strides).
COLLECTIVE_CASES = (
    ("multi_ring", (1,)), ("multi_ring", (3,)), ("multi_ring", (5,)), ("multi_ring", (7,)),
    ("multi_ring", (1, 3)), ("multi_ring", (1, 3, 5)), ("multi_ring", (1, 3, 5, 7)),
    ("recursive_hd", ()), ("multi_tree", (1,)), ("multi_tree", (1, 3)),
    ("multi_tree", (1, 3, 5)), ("psum", ()),
)
MESH_STRIDES = {"plain": 1, "stride3": 3}
# The inputs each mesh runs: all on the plain mesh, two on the reordered one.
MESH_INPUTS = {"plain": ("arange_f32", "arange_i32", "normal_f32", "normal_f32_1003"),
               "stride3": ("arange_i32", "normal_f32")}


def collective_inputs() -> dict:
    """Rows of 8 ranks: ``tests/test_collectives.py``'s inputs (13 float32
    and 11 int32 elements a rank, both ragged over 8), random float32 rows,
    whose sums depend on the order of the additions, and a ragged 1003."""
    rng = np.random.default_rng(0)
    return {
        "arange_f32": np.arange(8 * 13, dtype=np.float32).reshape(8, 13),
        "arange_i32": np.arange(8 * 11, dtype=np.int32).reshape(8, 11),
        "normal_f32": rng.standard_normal((8, 13)).astype(np.float32),
        "normal_f32_1003": rng.standard_normal((8, 1003)).astype(np.float32),
    }


def scatter_inputs() -> dict:
    rng = np.random.default_rng(1)
    return {"arange": np.arange(8 * 16, dtype=np.float32).reshape(8, 16),
            "normal": rng.standard_normal((8, 16)).astype(np.float32)}


def a2a_input() -> np.ndarray:
    return np.arange(8 * 8 * 4, dtype=np.float32).reshape(8, 8, 4)


def gpipe_inputs() -> dict:
    rng = np.random.default_rng(2)
    return {"w": (0.5 * rng.standard_normal((4, 16, 16))).astype(np.float32),
            "b": rng.standard_normal((4, 16)).astype(np.float32),
            "mbs": {m: rng.standard_normal((m, 2, 16)).astype(np.float32) for m in (1, 2, 5, 6)}}


def gpipe_stage(params, x):
    """The port's stage function, tanh(x W + b), as the JAX side's."""
    return (x @ params["w"] + params["b"]).tanh()


# --------------------------------------------------------------------------
# jobs: (rank, inputs) -> result, on a joined process group
# --------------------------------------------------------------------------


def _collectives(rank, inputs):
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.core.device_order import topoopt_mesh

    out = {"mesh": {}, "cases": {}, "scatter": {}, "a2a": {}}
    for mesh_name, stride in MESH_STRIDES.items():
        mesh = topoopt_mesh((8,), ("x",), allreduce_axis="x", stride=stride)
        axis = mesh.axis("x")
        pos = axis.index
        out["mesh"][mesh_name] = (axis.ranks, pos)
        for in_name in MESH_INPUTS[mesh_name]:
            x = torch.from_numpy(collective_inputs()[in_name][pos:pos + 1].copy())
            for kind, strides in COLLECTIVE_CASES:
                if kind == "psum":
                    y = C.psum(x, axis)
                elif kind == "recursive_hd":
                    y = C.recursive_hd_all_reduce(x, axis)
                else:
                    y = getattr(C, f"{kind}_all_reduce")(x, axis, strides)
                out["cases"][(mesh_name, in_name, kind, strides)] = y.numpy()
        for in_name, arr in scatter_inputs().items():
            x = torch.from_numpy(arr[pos:pos + 1].copy())
            out["scatter"][(mesh_name, in_name)] = C.ring_reduce_scatter(x, axis, 3).numpy()
        y = torch.from_numpy(a2a_input()[pos].copy())
        for p in (1, 3, 5):
            out["a2a"][(mesh_name, p)] = C.all_to_all_ring(y, axis, p).numpy()
    return out


def _four_ranks(rank, inputs):
    """GPipe over 4 stages, and a 2 x 2 mesh: each axis's ranks, this rank's
    position, and a sum of (rank + 1) over the axis by ``psum`` (the axis's
    own process group) and by the ring (point to point)."""
    import torch

    from repro_torch.core.collectives import multi_ring_all_reduce, psum
    from repro_torch.core.device_order import topoopt_mesh
    from repro_torch.parallel.pipeline import make_gpipe_step

    g = gpipe_inputs()
    mesh = topoopt_mesh((4,), ("pipe",), allreduce_axis="pipe")
    run = make_gpipe_step(gpipe_stage, mesh, "pipe")
    params = {"w": torch.from_numpy(g["w"]), "b": torch.from_numpy(g["b"])}
    out = {m: run(params, torch.from_numpy(mbs)).numpy() for m, mbs in g["mbs"].items()}
    grid = topoopt_mesh((2, 2), ("a", "b"), allreduce_axis="b")
    x = torch.full((3,), float(rank + 1))
    out["mesh2d"] = {}
    for name in ("a", "b"):
        axis = grid.axis(name)
        out["mesh2d"][name] = (axis.ranks, axis.index, psum(x, axis).numpy(),
                               multi_ring_all_reduce(x, axis, (1,)).numpy())
    return out


def _compression(rank, inputs):
    import torch

    from repro_torch.core.device_order import topoopt_mesh
    from repro_torch.parallel.compression import Compressor, compressed_ring_all_reduce

    mesh = topoopt_mesh((8,), ("x",), allreduce_axis="x")
    axis = mesh.axis("x")
    pos = axis.index
    out = {"ring": {}, "sync": None, "quadratic": None}
    for key, arr in inputs["ring"].items():
        p, block = key[0], key[1]
        y, res = compressed_ring_all_reduce(torch.from_numpy(arr[pos].copy()), axis, p=p,
                                            block=block)
        out["ring"][key] = (y.numpy(), res.numpy())
    comp = Compressor(block=32)
    grads = {k: torch.from_numpy(v[pos].copy()) for k, v in inputs["sync_grads"].items()}
    res = {k: torch.from_numpy(v[pos].copy()) for k, v in inputs["sync_res"].items()}
    g, r = comp.sync(grads, res, axis, strides=(1, 3))
    out["sync"] = ({k: v.numpy() for k, v in g.items()}, {k: v.numpy() for k, v in r.items()})
    # Error-feedback SGD on a quadratic (tests/test_compression.py's).
    target = torch.from_numpy(inputs["target"])
    w = torch.zeros(64)
    residual = torch.zeros(64)
    for noise in inputs["noise"]:
        gl = (w - target) + 0.01 * torch.from_numpy(noise[pos].copy())
        gs, nr = comp.sync({"w": gl}, {"w": residual}, axis, strides=(1, 3))
        w, residual = w - 0.3 * gs["w"], nr["w"]
    out["quadratic"] = w.numpy()
    return out


def _dp_train(rank, inputs):
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.core.device_order import topoopt_mesh
    from repro_torch.data.pipeline import DataSpec, batch_for_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw, wsd
    from repro_torch.parallel.compression import Compressor
    from repro_torch.train import steps
    from repro_torch.weights import params_from_jax

    cfg = dataclasses.replace(get_config("granite-8b").smoke(), param_dtype="float32",
                              activation_dtype="float32")
    strides = tuple(inputs["strides"])
    mesh = topoopt_mesh((8,), ("data",), stride=strides[0])
    spec = DataSpec(cfg=cfg, shape=ShapeSpec("dp", 32, 8, "train"), seed=0)
    out = {"pos": mesh.axis("data").index}
    exact = steps.loss_and_grads
    gen = torch.Generator().manual_seed(rank)

    def one_ulp_off(*args, **kwargs):
        """The step's gradients, each entry moved by -1, 0 or +1 ulp at random."""
        total, metrics, params, grads = exact(*args, **kwargs)
        return total, metrics, params, {
            k: g * (1 + 2.0**-23 * torch.randint(-1, 2, g.shape, generator=gen).float())
            for k, g in grads.items()}

    for variant in ("ring", "recursive_hd", "multi_tree", "compressed", "compressed_ulp"):
        steps.loss_and_grads = one_ulp_off if variant == "compressed_ulp" else exact
        model = lm.init(0, cfg, device="cpu")
        model.load_state_dict(params_from_jax(inputs["params"], cfg))
        opt = adamw(wsd(1e-3, 10))  # the test's LR
        state = opt.init(dict(model.named_parameters()))
        comp = Compressor() if variant.startswith("compressed") else None
        step = steps.make_shardmap_dp_train_step(
            cfg, opt, mesh, "data", ring_strides=strides, compressor=comp,
            schedule="ring" if comp else variant)
        residual = steps.init_compressor_residual(comp, model) if comp else None
        losses = []
        for s in range(3):
            batch = {k: torch.from_numpy(v) for k, v in batch_for_step(spec, s).items()}
            _, _, loss, residual = step(model, state, batch, s, residual)
            losses.append(float(loss))
        out[variant] = (losses, {k: v.detach().numpy().copy()
                                 for k, v in model.named_parameters()})
    return out


# The GSPMD trainer's cases on a (2, 4) ("data", "model") mesh: name ->
# (arch, ShardingPlan fields).  ZeRO-1 replicates the parameters
# (fsdp=False) and shards the moments.
GSPMD_VARIANTS = {
    "fsdp": ("granite-8b", {"fsdp": True}),
    "no_fsdp": ("granite-8b", {"fsdp": False}),
    "zero1": ("granite-8b", {"fsdp": False, "zero1": True}),
    "seq_parallel": ("granite-8b", {"fsdp": True, "seq_parallel": True}),
    "moe": ("qwen3-moe-30b-a3b", {"fsdp": True}),
    "ssm": ("falcon-mamba-7b", {"fsdp": True}),
}
# The smoke configs' changes, the same on both sides: fp32, and a capacity
# of 1.0 for the MoE (the smoke config's 4.0 drops nothing), so its drops
# depend on the global batch.
GSPMD_CONFIGS = {
    "granite-8b": {"param_dtype": "float32", "activation_dtype": "float32"},
    "qwen3-moe-30b-a3b": {"param_dtype": "float32", "activation_dtype": "float32",
                          "capacity_factor": 1.0},
    "falcon-mamba-7b": {"param_dtype": "float32", "activation_dtype": "float32"},
}
GSPMD_LR, GSPMD_STEPS, GSPMD_SEQ, GSPMD_BATCH = 1e-3, 3, 32, 8


def gspmd_config(arch: str):
    import dataclasses

    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(arch).smoke(), **GSPMD_CONFIGS[arch])


def _gspmd_train(rank, inputs):
    """Each of ``inputs["variants"]`` (names of GSPMD_VARIANTS; or
    ``"moe_local"``: the MoE routing each rank's rows alone, as it would
    without ``gather_batch``; or ``"reordered"``: "fsdp" on a (4, 2) mesh
    whose data axis takes TotientPerms stride 3, ranks 0, 6, 4, 2 in data
    order) from the JAX weights: losses and grad norms of 3 steps, every
    parameter's and first moment's local shard shape, this rank's data
    position, and on rank 0 the parameters whole."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.device_order import topoopt_mesh
    from repro_torch.data.pipeline import DataSpec, batch_for_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers, lm
    from repro_torch.optim import adamw, wsd
    from repro_torch.parallel.sharding import ShardingPlan, parameters, place
    from repro_torch.train.steps import init_opt_state, jit_train_step
    from repro_torch.weights import params_from_jax

    test_mesh = make_test_mesh((2, 4), ("data", "model"))
    reordered = topoopt_mesh((4, 2), ("data", "model"), allreduce_axis="data", stride=3)
    gather = layers.gather_batch
    out = {"pos": {a: test_mesh.axis(a).index for a in test_mesh.axis_names}}
    for name in inputs["variants"]:
        arch, kw = GSPMD_VARIANTS[{"moe_local": "moe", "reordered": "fsdp"}.get(name, name)]
        mesh = reordered if name == "reordered" else test_mesh
        layers.gather_batch = (lambda x: (x, slice(None))) if name == "moe_local" else gather
        cfg = gspmd_config(arch)
        opt = adamw(wsd(GSPMD_LR, 10))
        step, (_, _, p_layouts, o_layouts, _) = jit_train_step(cfg, opt, ShardingPlan(**kw),
                                                               mesh, device="cpu")
        model = lm.init(0, cfg, device="cpu")
        model.load_state_dict(params_from_jax(inputs["params"][arch], cfg))
        place(model, p_layouts)
        state = init_opt_state(opt, model, o_layouts)
        spec = DataSpec(cfg=cfg, shape=ShapeSpec("gspmd", GSPMD_SEQ, GSPMD_BATCH, "train"))
        losses, norms = [], []
        for s in range(GSPMD_STEPS):
            batch = {k: torch.from_numpy(v) for k, v in batch_for_step(spec, s).items()}
            _, _, metrics = step(model, state, batch, s)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        params = parameters(model)
        whole = {n: p.detach().full_tensor().numpy() for n, p in params.items()}
        out[name] = {
            "losses": losses, "grad_norms": norms,
            "local": {n: tuple(p.to_local().shape) for n, p in params.items()},
            "local_m": {n: tuple(t.to_local().shape) for n, t in state["m"].items()},
            "data_pos": mesh.axis("data").index,
            "params": whole if rank == 0 else None,
        }
    layers.gather_batch = gather
    return out


def _gspmd_loop(rank, inputs):
    """The training loop on a (2, 4) mesh under ``fsdp=True``: an
    uninterrupted run, and a run failing at step 10 then resumed, with
    checkpoints every 5 steps in ``inputs["dirs"]``; then the command line's
    ``--mesh single`` at this world of 8."""
    from repro_torch.checkpoint.ckpt import latest_step
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import adamw, wsd
    from repro_torch.parallel.sharding import ShardingPlan
    from repro_torch.train.loop import InjectedFailure, train

    cfg, shape = gspmd_config("granite-8b"), inputs["shape"]
    mesh = make_test_mesh((2, 4), ("data", "model"))
    run = dict(total_steps=12, ckpt_every=5, log_every=100, logger=lambda *a: None,
               device="cpu")
    opt = adamw(wsd(GSPMD_LR, 12))
    plan = ShardingPlan(fsdp=True)
    whole = train(cfg, shape, opt, plan, mesh, ckpt_dir=inputs["dirs"]["whole"], **run)
    try:
        train(cfg, shape, opt, plan, mesh, ckpt_dir=inputs["dirs"]["run"], fail_at=10, **run)
        failed_at = None
    except InjectedFailure:
        failed_at = latest_step(inputs["dirs"]["run"])
    resumed = train(cfg, shape, opt, plan, mesh, ckpt_dir=inputs["dirs"]["run"], **run)
    try:
        train_cli.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--mesh", "single",
                        "--steps", "1"])
        single = None
    except ValueError as e:
        single = str(e)
    return {"whole": whole.losses, "failed_at": failed_at, "resumed": resumed.losses,
            "resumed_final": resumed.final_step, "single": single}


JOBS = {"collectives": _collectives, "four_ranks": _four_ranks, "compression": _compression,
        "dp_train": _dp_train, "gspmd_train": _gspmd_train, "gspmd_loop": _gspmd_loop}


def _main(job: str, rank: int, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg", rank=rank,
                            world_size=world, timeout=timedelta(seconds=PG_TIMEOUT))
    try:
        result = JOBS[job](rank, inputs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(job: str, world: int, workdir: Path, inputs=None, timeout: int = 300) -> list:
    """Runs ``job`` on ``world`` gloo ranks -> its result on each rank; every
    rank is killed ``timeout`` seconds after the start."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r), str(world), str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    errors = []
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise AssertionError("\n".join(errors))
    results = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
