"""Multi-pod dry run (``repro.launch.dryrun``'s counterpart): every (arch x
shape x mesh) cell's real train or serve step, run once on tensors that hold
no data, op by op under :class:`~repro_torch.launch.op_analysis.OpAnalysis`,
for the roofline (:mod:`repro_torch.launch.roofline`).

    python -m repro_torch.launch.dryrun --arch granite-8b --shape decode_32k --mesh single

The reference forces 512 host devices and compiles each step on shape
structs.  Here one process joins a ``"fake"`` process group of the mesh's
256 or 512 ranks as rank 0 (``launch.mesh.fake_world``), builds
``jit_train_step`` (AdamW) or ``jit_serve_step`` with the plan's layouts,
and runs the step on ``meta`` tensors, which stand for the card: every
layer, DTensor redistribution and collective runs as it would on rank 0 of
the mesh, each kernel op through its fake implementation, and nothing is
allocated or computed.  A ``meta`` tensor, not a fake CUDA one, stands for
the card because autograd asks for the CUDA device guard of a CUDA tensor,
which a build of PyTorch without CUDA aborts on.

A cell's record keeps the reference's keys where they mean something:
``memory`` holds the bytes the step held before it ran (parameters,
optimizer state, the global batch), the most its own tensors held at once
and their sum, the predicted peak; ``hlo`` the per-device product FLOPs and
bytes; ``collectives`` the payloads by type.  ``lower_s`` and ``compile_s``
become ``build_s`` (step, model, state and batch) and ``step_s``, and
``xla_cost`` (the compiler's own count) has no counterpart.  ``launches``
holds the kernel launches of the step (``kernels.ops``'s counters).  The
flags are the reference's that change what the port runs: the plan's and
``--lowp-norm``.  Its ``--attention``, ``--scan`` and MoE-constraint flags
choose among XLA lowerings; the port has one attention path and one scan
path (the kernels) and writes its MoE dispatch out, so it takes none of
them.
Importing this module joins no process group and touches no card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs.base import (
    ALL_SHAPES,
    ArchConfig,
    ShapeSpec,
    all_configs,
    get_config,
    input_specs,
    shape_applicability,
)
from ..kernels import ops
from ..models import lm
from ..optim import adamw, constant
from ..parallel.options import ModelOptions, set_options
from ..parallel.sharding import ShardingPlan, parameters, placer, shard
from ..train.steps import init_opt_state, jit_serve_step, jit_train_step
from .mesh import fake_world, make_production_mesh
from .op_analysis import OpAnalysis
from .roofline import roofline

MODELLED_CARD = torch.device("meta")
LAUNCH_COUNTERS = tuple(n for n in vars(ops) if n.endswith("_launches"))


def plan_from_args(args) -> ShardingPlan:
    return ShardingPlan(
        fsdp=not args.no_fsdp,
        seq_parallel=args.seq_parallel,
        remat=args.remat,
        loss_chunk=args.loss_chunk,
    )


def _global_batch(cfg: ArchConfig, shape: ShapeSpec, batch_fn) -> dict:
    """The cell's global batch on the modelled card; a decode cell's cache
    as the prefill leaves it (``batch_fn``'s layouts) and its position the
    last slot, on the host, where the step reads it."""
    specs = input_specs(cfg, shape)
    batch = {k: torch.zeros(spec[0], dtype=spec[1], device=MODELLED_CARD)
             for k, spec in specs.items() if k not in ("pos", "cache")}
    if shape.kind == "decode":
        batch["pos"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
        lay = batch_fn(shape)["cache"]
        batch["cache"] = {n: shard(torch.empty(s, dtype=dt, device=MODELLED_CARD), lay[n])
                          for n, (s, dt) in specs["cache"].items()}
    return batch


def dryrun_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, plan: ShardingPlan) -> dict:
    """Runs one cell's step on the modelled card over ``mesh`` (a process
    group of its size must exist: ``launch.mesh.fake_world``); returns the
    §Dry-run record."""
    chips = int(mesh.devices.size)
    t0 = time.perf_counter()
    opt_state = None
    if shape.kind == "train":
        optimizer = adamw(constant(3e-4))
        step, (_, _, p_layouts, o_layouts, batch_fn) = jit_train_step(
            cfg, optimizer, plan, mesh, MODELLED_CARD)
    else:
        step, (_, p_layouts, batch_fn) = jit_serve_step(cfg, shape, plan, mesh, MODELLED_CARD)
    model = lm.init(0, cfg, MODELLED_CARD, place=placer(p_layouts))
    if shape.kind == "train":
        opt_state = init_opt_state(optimizer, model, o_layouts)
    batch = _global_batch(cfg, shape, batch_fn)
    build_s = time.perf_counter() - t0

    analysis = OpAnalysis()
    analysis.hold((parameters(model), opt_state, batch))
    before = {n: getattr(ops, n) for n in LAUNCH_COUNTERS}
    t0 = time.perf_counter()
    with analysis:
        out = step(model, opt_state, batch, 0) if opt_state is not None else step(model, batch)
    step_s = time.perf_counter() - t0
    launches = {n: getattr(ops, n) - before[n] for n in LAUNCH_COUNTERS
                if getattr(ops, n) != before[n]}
    res = analysis.result()
    terms = roofline(res, res["collective_bytes"], chips, cfg, shape)

    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": {a: int(mesh.shape[a]) for a in mesh.axis_names},
        "chips": chips,
        "plan": {
            "fsdp": plan.fsdp,
            "seq_parallel": plan.seq_parallel,
            "remat": plan.remat,
            "loss_chunk": plan.loss_chunk,
        },
        "build_s": build_s,
        "step_s": step_s,
        "memory": {
            "argument_size_in_bytes": res["argument_bytes"],
            "output_size_in_bytes": analysis.made_bytes(out),
            "temp_size_in_bytes": res["peak_temp_bytes"],
            "peak_size_in_bytes": res["peak_bytes"],
        },
        "hlo": {
            "flops_per_dev": res["flops"],
            "bytes_per_dev": res["bytes"],
        },
        "collectives": {
            "total_bytes": res["collective_bytes"],
            "by_type": res["collectives_by_type"],
        },
        "launches": launches,
        "roofline": terms.as_dict(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="TopoOpt multi-pod dry-run on the port")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--lowp-norm", action="store_true")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)

    set_options(ModelOptions(lowp_norm=args.lowp_norm))

    configs = all_configs()
    archs = [get_config(args.arch)] if args.arch else [
        c for c in configs.values() if c.family != "recsys"
    ]
    shapes = [s for s in ALL_SHAPES if args.shape is None or s.name == args.shape]
    pods = [p for p in ("single", "multi") if args.mesh in (p, "both")]

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    cells = []
    for cfg in archs:
        for shape in shapes:
            ok, why = shape_applicability(cfg, shape)
            if not ok:
                print(f"SKIP  {cfg.name} x {shape.name}: {why}", flush=True)
                n_skip += 1
            else:
                cells.append((cfg, shape))
    for pod in pods:  # one fake world a mesh, every cell in it
        mesh_name = f"{pod}_pod"
        made = fake_world(512 if pod == "multi" else 256)
        mesh = make_production_mesh(multi_pod=pod == "multi")
        for cfg, shape in cells:
            plan = plan_from_args(args)
            tag = f"{cfg.name}_{shape.name}_{mesh_name}_{args.tag}"
            try:
                rec = dryrun_cell(cfg, shape, mesh, plan)
                rec["mesh_name"] = mesh_name
                rec["tag"] = args.tag
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                r = rec["roofline"]
                print(
                    f"OK    {tag}: step={rec['step_s']:.1f}s "
                    f"dominant={r['dominant']} "
                    f"compute={r['compute_s']*1e3:.2f}ms "
                    f"mem={r['memory_s']*1e3:.2f}ms "
                    f"coll={r['collective_s']*1e3:.2f}ms "
                    f"useful={r['useful_fraction']:.2f} mfu={r['mfu']:.3f} "
                    f"peak={rec['memory']['peak_size_in_bytes'] / 1e9:.2f}GB",
                    flush=True,
                )
                n_ok += 1
            except Exception:
                print(f"FAIL  {tag}", flush=True)
                traceback.print_exc()
                n_fail += 1
        if made:
            dist.destroy_process_group()
    print(f"dry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
