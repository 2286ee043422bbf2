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
# (GSPMD_CONFIGS key, ShardingPlan fields).  ZeRO-1 replicates the
# parameters (fsdp=False) and shards the moments.  "tied_chunk*": the tied
# vocabulary-parallel head through the chunked loss (8-token chunks, each
# recomputed in the backward); "indivisible*": layers whose heads,
# vocabulary and MLP columns do not divide the model axis, computed whole.
GSPMD_VARIANTS = {
    "fsdp": ("granite-8b", {"fsdp": True}),
    "no_fsdp": ("granite-8b", {"fsdp": False}),
    "zero1": ("granite-8b", {"fsdp": False, "zero1": True}),
    "seq_parallel": ("granite-8b", {"fsdp": True, "seq_parallel": True}),
    "moe": ("qwen3-moe-30b-a3b", {"fsdp": True}),
    "ssm": ("falcon-mamba-7b", {"fsdp": True}),
    "hybrid": ("recurrentgemma-9b", {"fsdp": True}),
    "vlm": ("llama-3.2-vision-11b", {"fsdp": True}),
    "audio": ("hubert-xlarge", {"fsdp": True}),
    "moe_seq": ("qwen3-moe-30b-a3b", {"fsdp": True, "seq_parallel": True}),
    "tied_chunk": ("minicpm-2b", {"fsdp": True, "loss_chunk": 8}),
    "tied_chunk_seq": ("minicpm-2b", {"fsdp": True, "seq_parallel": True, "loss_chunk": 8}),
    "indivisible": ("indivisible", {"fsdp": True}),
    "indivisible_seq": ("indivisible", {"fsdp": True, "seq_parallel": True}),
}
# The configs: name -> (arch, changes to its smoke config), the same on both
# sides: fp32, and a capacity of 1.0 for the MoE (the smoke config's 4.0
# drops nothing), so its drops depend on the global batch.  "indivisible":
# granite-8b's with 2 query heads, 250 tokens and 130 MLP columns, none of
# which divides 4.
_FP32 = {"param_dtype": "float32", "activation_dtype": "float32"}
GSPMD_CONFIGS = {
    "granite-8b": ("granite-8b", _FP32),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", dict(_FP32, capacity_factor=1.0)),
    "falcon-mamba-7b": ("falcon-mamba-7b", _FP32),
    "recurrentgemma-9b": ("recurrentgemma-9b", _FP32),
    "llama-3.2-vision-11b": ("llama-3.2-vision-11b", _FP32),
    "hubert-xlarge": ("hubert-xlarge", _FP32),
    "minicpm-2b": ("minicpm-2b", _FP32),
    "indivisible": ("granite-8b", dict(_FP32, n_heads=2, vocab=250, d_ff=130)),
}
# The VLM's cross gates, set in the JAX parameters before both sides run:
# at their initial 0, tanh(0) = 0 throws the cross-attention away.
GSPMD_GATE = 0.5
GSPMD_LR, GSPMD_STEPS, GSPMD_SEQ, GSPMD_BATCH = 1e-3, 3, 32, 8


def gspmd_config(name: str):
    """The port's config ``name`` of GSPMD_CONFIGS."""
    import dataclasses

    from repro_torch.configs.base import get_config

    arch, over = GSPMD_CONFIGS[name]
    return dataclasses.replace(get_config(arch).smoke(), **over)


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
        key, kw = GSPMD_VARIANTS[{"moe_local": "moe", "reordered": "fsdp"}.get(name, name)]
        mesh = reordered if name == "reordered" else test_mesh
        layers.gather_batch = (lambda x: (x, slice(None))) if name == "moe_local" else gather
        cfg = gspmd_config(key)
        opt = adamw(wsd(GSPMD_LR, 10))
        step, (_, _, p_layouts, o_layouts, _) = jit_train_step(cfg, opt, ShardingPlan(**kw),
                                                               mesh, device="cpu")
        model = lm.init(0, cfg, device="cpu")
        model.load_state_dict(params_from_jax(inputs["params"][key], cfg))
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


# The split compute's cases on the (2, 4) mesh: name -> (arch, changes to its
# smoke config on top of GSPMD_CONFIGS' fp32).  "indivisible": 2 query heads,
# 250 tokens and 130 MLP columns, none of which divides 4; "experts6": 6
# experts; "lru66": 66 RG-LRU channels, whose layers compute whole.
TP_CASES = {
    "dense": ("granite-8b", {}),
    "tied": ("minicpm-2b", {}),
    "moe": ("qwen3-moe-30b-a3b", {}),
    "ssm": ("falcon-mamba-7b", {}),
    "hybrid": ("recurrentgemma-9b", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
    "audio": ("hubert-xlarge", {}),
    "indivisible": ("granite-8b", {"n_heads": 2, "vocab": 250, "d_ff": 130}),
    "experts6": ("qwen3-moe-30b-a3b", {"n_experts": 6}),
    "lru66": ("recurrentgemma-9b", {"lru_width": 66}),
}
TP_PLANS = {"fsdp": {"fsdp": True}, "seq": {"fsdp": True, "seq_parallel": True}}


def tp_config(case: str):
    import dataclasses

    from repro_torch.configs.base import get_config

    arch, over = TP_CASES[case]
    return dataclasses.replace(get_config(arch).smoke(), param_dtype="float32",
                               activation_dtype="float32", **over)


def tp_collective_inputs(index: int) -> dict:
    """Model rank ``index``'s inputs and upstream gradients for each model
    axis collective (the same on both data rows of the mesh)."""
    rng = np.random.default_rng(100 + index)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    common = np.random.default_rng(99).standard_normal((2, 12, 5)).astype(np.float32)
    return {"x": f(2, 3, 5), "x_seq": f(2, 12, 5), "g_share": f(2, 3, 5),
            "g_whole": f(2, 12, 5), "g_common": common}


def _tp_collectives(mesh):
    """enter / reduce / gather_seq / scatter_seq, and constrain's 'whole'
    and 'btd' under sequence parallelism, each forward and its input's
    gradient under an upstream gradient of this model rank's own ('whole':
    one the same on every rank, as its consumers give it)."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel import act_sharding as A

    index = sorted(mesh.axis("model").ranks).index(dist.get_rank())
    inp = {k: torch.from_numpy(v) for k, v in tp_collective_inputs(index).items()}
    cases = {"enter": (A.enter, "x", "g_share"), "reduce": (A.reduce, "x", "g_share"),
             "gather_seq": (A.gather_seq, "x", "g_whole"),
             "scatter_seq": (A.scatter_seq, "x_seq", "g_share"),
             "whole": (lambda t: A.constrain(t, "whole"), "x", "g_common"),
             "btd": (lambda t: A.constrain(t, "btd"), "x_seq", "g_share")}
    policy = A.ActivationPolicy(dp="data", tp="model", seq="model", mesh=mesh)
    out = {"index": index}
    with A.using_policy(policy):
        for name, (fn, x_of, g_of) in cases.items():
            x = inp[x_of].clone().requires_grad_(True)
            y = fn(x)
            (grad,) = torch.autograd.grad(y, x, inp[g_of])
            out[name] = (y.detach().numpy(), grad.numpy())
    return out


def _tp_compute(rank, inputs):
    """Each TP_CASES case under each TP_PLANS plan on the (2, 4) mesh, one
    ``jit_train_step`` from seed 0: the shapes the plain kernels and the
    matmuls received (``ops.attention``'s q and k, ``ops.grouped_matmul``'s
    x, the scans' first input, every ``@``'s right operand, the loss's
    logits), the parameters gathered over ``"model"``, the loss and the
    gradients' largest error against ``loss_and_grads`` of the plain model
    on the global batch; then the model axis's collectives."""
    import torch
    from torch.overrides import TorchFunctionMode

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataSpec, batch_for_step
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw, wsd
    from repro_torch.parallel import sharding
    from repro_torch.parallel.act_sharding import using_policy
    from repro_torch.train import steps

    mesh = make_test_mesh((2, 4), ("data", "model"))
    record = None

    def recording(name, fn, shape_of):
        def wrapped(*args, **kwargs):
            if record is not None:
                record[name].append(shape_of(*args))
            return fn(*args, **kwargs)
        return wrapped

    kernels = {"attention": lambda q, k, *a: (tuple(q.shape), tuple(k.shape)),
               "grouped_matmul": lambda x, w: tuple(x.shape),
               "selective_scan": lambda xc, *a: tuple(xc.shape),
               "lru_scan": lambda a, b: tuple(a.shape)}
    real = {name: getattr(ops, name) for name in kernels}
    real_nll, real_gather = lm._nll, sharding._Gather.forward
    for name, shape_of in kernels.items():
        setattr(ops, name, recording(name, real[name], shape_of))
    lm._nll = recording("logits", real_nll, lambda logits, *a: tuple(logits.shape))

    def gather(self, w):
        if record is not None:
            from repro_torch.parallel.act_sharding import read_of
            split = any(a == "model" and pl.is_shard()
                        for a, pl in zip(w.device_mesh.mesh_dim_names, w.placements))
            if split and read_of(self.name).dim is None:
                record["whole_over_model"].add(self.name)
        return real_gather(self, w)

    sharding._Gather.forward = gather

    class Products(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if record is not None and getattr(func, "__name__", "") in ("matmul", "__matmul__"):
                record["matmul"].add(tuple(args[1].shape))
            return func(*args, **(kwargs or {}))

    out = {"collectives": _tp_collectives(mesh), "cases": {}}
    try:
        for case in TP_CASES:
            cfg = tp_config(case)
            spec = DataSpec(cfg=cfg, shape=ShapeSpec("tp", GSPMD_SEQ, GSPMD_BATCH, "train"))
            batch = {k: torch.from_numpy(v) for k, v in batch_for_step(spec, 0).items()}
            plain = lm.init(0, cfg, device="cpu")
            want_loss, _, _, want = steps.loss_and_grads(plain, batch, cfg)
            for plan_name, kw in TP_PLANS.items():
                plan = sharding.ShardingPlan(**kw)
                opt = adamw(wsd(GSPMD_LR, 10))
                _, (_, _, p_layouts, _, _) = steps.jit_train_step(cfg, opt, plan, mesh,
                                                                 device="cpu")
                model = lm.init(0, cfg, device="cpu", place=sharding.placer(p_layouts))
                pos = mesh.axis("data").index
                local = {k: v[pos * (v.shape[0] // 2):(pos + 1) * (v.shape[0] // 2)]
                         for k, v in batch.items()}
                record = {name: [] for name in list(kernels) + ["logits"]}
                record.update(matmul=set(), whole_over_model=set())
                with using_policy(steps.activation_policy(plan, mesh, cfg)), Products():
                    loss, _, _, grads = steps.loss_and_grads(model, local, cfg)
                got = record
                record = None
                errs = {n: float((grads[n].full_tensor() - g).abs().max()
                                 / max(float(g.abs().max()), 1e-30)) for n, g in want.items()}
                out["cases"][(case, plan_name)] = {
                    **{k: v for k, v in got.items()},
                    "loss": float(loss), "want_loss": float(want_loss), "grad_errs": errs,
                }
    finally:
        for name in kernels:
            setattr(ops, name, real[name])
        lm._nll, sharding._Gather.forward = real_nll, real_gather
    return out


# The mesh serve step's cases on the (2, 4) mesh: name -> (GSPMD_CONFIGS key,
# ShardingPlan fields, prompt length, pad_to).  A prompt of 12 and 4 decode
# steps in 16 slots: 4 positions a model rank.  "masked": 32 slots, so at the
# first decode step ranks 2 and 3 hold no valid position; "whole": 30 slots,
# which do not divide over 4, so each rank holds the whole sequence.
# Griffin's window is 16: its 12-token prompt leaves a 12-slot cache, its
# 20-token one a ring that has wrapped.  minicpm-2b: 4 KV heads, one a rank
# (the all-to-all), and a tied head split by vocabulary.
SERVE_CASES = {
    "fsdp": ("granite-8b", {"fsdp": True}, 12, 16),
    "no_fsdp": ("granite-8b", {"fsdp": False}, 12, 16),
    "seq_parallel": ("granite-8b", {"fsdp": True, "seq_parallel": True}, 12, 16),
    "moe": ("qwen3-moe-30b-a3b", {"fsdp": True}, 12, 16),
    "ssm_12": ("falcon-mamba-7b", {"fsdp": True}, 12, 0),
    "ssm_20": ("falcon-mamba-7b", {"fsdp": True}, 20, 0),
    "hybrid_12": ("recurrentgemma-9b", {"fsdp": True}, 12, 0),
    "hybrid_20": ("recurrentgemma-9b", {"fsdp": True}, 20, 0),
    "hybrid_20_seq": ("recurrentgemma-9b", {"fsdp": True, "seq_parallel": True}, 20, 0),
    "vlm": ("llama-3.2-vision-11b", {"fsdp": True}, 12, 16),
    "audio": ("hubert-xlarge", {"fsdp": True}, 12, 0),
    "masked": ("granite-8b", {"fsdp": True}, 12, 32),
    "whole": ("granite-8b", {"fsdp": True}, 12, 30),
    "kv_heads": ("minicpm-2b", {"fsdp": True, "seq_parallel": True}, 12, 16),
}
SERVE_BATCH, SERVE_DECODE = 4, 4


def serve_inputs(name: str, cfg) -> dict:
    """Case ``name``'s global prefill batch, numpy from a seed: the tokens
    (the audio encoder's frames), and the VLM's image."""
    _, _, S, _ = SERVE_CASES[name]
    rng = np.random.default_rng(7)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((SERVE_BATCH, S, cfg.d_model)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (SERVE_BATCH, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (SERVE_BATCH, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _serve_mesh(rank, inputs):
    """Each SERVE_CASES case from the JAX weights: ``jit_serve_step``'s
    prefill and SERVE_DECODE greedy decode steps; the logits of each, the
    generated ids, every cache leaf whole after the prefill and after the
    last step, and this rank's shard shapes."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ShardingPlan, place
    from repro_torch.train.steps import jit_serve_step
    from repro_torch.weights import params_from_jax

    mesh = make_test_mesh((2, 4), ("data", "model"))
    out = {"pos": {a: mesh.axis(a).index for a in mesh.axis_names}}
    for name in inputs["cases"]:
        key, kw, S, pad_to = SERVE_CASES[name]
        cfg, plan = gspmd_config(key), ShardingPlan(**kw)
        prefill, (_, p_layouts, _) = jit_serve_step(
            cfg, ShapeSpec("p", S, SERVE_BATCH, "prefill"), plan, mesh, device="cpu",
            pad_to=pad_to)
        model = lm.init(0, cfg, device="cpu")
        model.load_state_dict(params_from_jax(inputs["params"][key], cfg))
        place(model, p_layouts)
        batch = {k: torch.from_numpy(v) for k, v in serve_inputs(name, cfg).items()}
        logits, cache = prefill(model, batch)
        whole = lambda c: {n: t.full_tensor().numpy().copy() for n, t in c.items()}  # noqa: E731
        rec = {"logits": [logits.numpy().copy()], "cache0": whole(cache),
               "local": {n: tuple(t.to_local().shape) for n, t in cache.items()}}
        if not cfg.is_encoder:
            T = cache["k"].shape[3] if "k" in cache else S
            decode, _ = jit_serve_step(cfg, ShapeSpec("d", T, SERVE_BATCH, "decode"), plan, mesh,
                                       device="cpu")
            tok = logits.argmax(-1)
            ids = [tok]
            for i in range(SERVE_DECODE):
                logits, cache = decode(model, {"token": tok, "pos": S + i, "cache": cache})
                rec["logits"].append(logits.numpy().copy())
                tok = logits.argmax(-1)
                ids.append(tok)
            rec["ids"] = torch.stack(ids, dim=1).numpy()
            rec["cache"] = whole(cache)
        out[name] = rec
    return out


def _serve_one_row(rank, inputs):
    """``jit_serve_step`` on one prompt, a row the 2 data ranks cannot split
    (``long_500k``'s batch): prefill and SERVE_DECODE greedy decode steps of
    each of ``inputs["cases"]`` (GSPMD_CONFIGS names, fsdp), from
    ``lm.init(0, ...)``; the logits of each step."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ShardingPlan, place
    from repro_torch.train.steps import jit_serve_step

    mesh, plan, S = make_test_mesh((2, 4), ("data", "model")), ShardingPlan(fsdp=True), 12
    out = {}
    for key in inputs["cases"]:
        cfg = gspmd_config(key)
        prefill, (_, p_layouts, _) = jit_serve_step(
            cfg, ShapeSpec("p", S, 1, "prefill"), plan, mesh, device="cpu", pad_to=16)
        model = place(lm.init(0, cfg, device="cpu"), p_layouts)
        logits, cache = prefill(model, {"tokens": torch.from_numpy(inputs["tokens"])})
        decode, _ = jit_serve_step(cfg, ShapeSpec("d", 16, 1, "decode"), plan, mesh,
                                   device="cpu")
        out[key] = [logits.numpy().copy()]
        for i in range(SERVE_DECODE):
            logits, cache = decode(model, {"token": logits.argmax(-1), "pos": S + i,
                                           "cache": cache})
            out[key].append(logits.numpy().copy())
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
        "dp_train": _dp_train, "gspmd_train": _gspmd_train, "gspmd_loop": _gspmd_loop,
        "tp_compute": _tp_compute, "serve_mesh": _serve_mesh, "serve_one_row": _serve_one_row}


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
