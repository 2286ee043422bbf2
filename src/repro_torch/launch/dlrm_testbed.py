"""Prototype reproduction (§6) in the port: trains the paper's DLRM and
estimates its all-to-all traffic's cost, mirroring Fig. 21; the twin of
``examples/dlrm_testbed.py``.

    PYTHONPATH=src python -m repro_torch.launch.dlrm_testbed [--device cpu]

Trains the example's small DLRM (8 tables of 512 x 32, batch 128, AdamW at
3e-3) on the card unless given ``--device cpu``, and fails unless its final
loss is below 0.6, as the example does; then prints the example's table of
per-iteration communication time on the 12-server testbed, on (a) the
TopoOpt plan, (b) Switch-100G (ideal) and (c) Switch-25G, across batch
sizes, from the port's planner on the host (NumPy), equal to the example's
text for text.  ``train_dlrm`` trains any ``DLRMConfig``, the paper's
widths included (``models.dlrm.paper_config``).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core import HardwareSpec, topology_finder
from repro_torch.core.simengine import ideal_switch_comm_time, topoopt_comm_time
from repro_torch.core.workloads import DLRM, job_demand
from repro_torch.models import dlrm
from repro_torch.optim import adamw, constant

# The example's training run.
SMALL_CFG = dlrm.DLRMConfig(n_tables=8, rows_per_table=512, embed_dim=32)
SMALL_BATCH, SMALL_LR = 128, 3e-3


def draw_batch(rng: np.random.Generator, cfg: dlrm.DLRMConfig, batch: int, device) -> dict:
    """One step's batch drawn from ``rng`` as the example draws it: the ids
    (``sparse``), then the dense features; labels ``sparse[:, 0] % 2``."""
    sparse = rng.integers(0, cfg.rows_per_table, (batch, cfg.n_tables))
    dense = rng.standard_normal((batch, cfg.dense_features))
    return {"dense": torch.tensor(dense, dtype=torch.float32, device=device),
            "sparse": torch.tensor(sparse, dtype=torch.int32, device=device),
            "label": torch.tensor(sparse[:, 0] % 2, dtype=torch.float32, device=device)}


def make_step(cfg: dlrm.DLRMConfig, opt):
    """-> ``step(model, opt_state, batch, i) -> loss``: ``dlrm.loss_fn``, its
    gradient for every parameter (``torch.autograd.grad``) and ``opt``'s
    update in place, as the example's jitted step does."""

    def step(model, opt_state, batch, i: int):
        params = dict(model.named_parameters())
        with torch.enable_grad():
            loss, _ = dlrm.loss_fn(model, batch, cfg)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        opt.update(grads, opt_state, params, i)
        return loss.detach()

    return step


@dataclass
class TrainRun:
    model: dlrm.DLRM
    losses: list[float]
    # Each step's host time after a synchronise, on a card; empty on the CPU.
    step_s: list[float] = field(default_factory=list)


def train_dlrm(cfg: dlrm.DLRMConfig, steps: int, batch: int, lr: float, seed: int = 0,
               device: str | torch.device | None = None) -> TrainRun:
    """Trains a DLRM of ``cfg`` from ``models.dlrm.init(seed)`` for ``steps``
    steps of AdamW (``constant(lr)``, no weight decay) on batches drawn by
    :func:`draw_batch` from ``np.random.default_rng(seed)``.  Runs on the
    card unless given ``device="cpu"`` (raises without one)."""
    device = resolve_device(device)
    model = dlrm.init(seed, cfg, device=device)
    model.requires_grad_(True)
    opt = adamw(constant(lr), weight_decay=0.0)
    state = opt.init(dict(model.named_parameters()))
    step = make_step(cfg, opt)
    rng = np.random.default_rng(seed)
    run = TrainRun(model=model, losses=[])
    for i in range(steps):
        b = draw_batch(rng, cfg, batch, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss = step(model, state, b, i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            run.step_s.append(time.perf_counter() - t0)
        run.losses.append(float(loss))
    return run


def train_small_dlrm(steps: int = 80, device: str | torch.device | None = None) -> float:
    """The example's run; prints the first and last loss, returns the last."""
    losses = train_dlrm(SMALL_CFG, steps, SMALL_BATCH, SMALL_LR, device=device).losses
    print(f"DLRM training: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses[-1]


def network_study() -> None:
    n, d = 12, 4  # the paper's 12-server testbed, degree 4
    print(f"\n{n}-server testbed, d={d} (Fig. 21 style):")
    print(f"{'batch':>6} {'a2a/ar':>7} {'topoopt':>9} {'sw100':>9} {'sw25':>9} {'tax':>5}")
    for bs in (64, 128, 256, 512):
        job = DLRM.with_batch(bs)
        dem = job_demand(job, n, table_hosts=range(0, n, 3))
        topo = topology_finder(dem, d)
        hw100 = HardwareSpec(link_bandwidth=25e9 / 8, degree=d)  # 4 x 25G
        res = topoopt_comm_time(topo, dem, hw100)
        t_sw100 = ideal_switch_comm_time(dem, HardwareSpec(link_bandwidth=100e9 / 8, degree=1))
        t_sw25 = ideal_switch_comm_time(dem, HardwareSpec(link_bandwidth=25e9 / 8, degree=1))
        ratio = dem.sum_mp / max(dem.sum_allreduce, 1e-9)
        print(
            f"{bs:6d} {ratio:7.2f} {res['comm_time']*1e3:8.2f}m "
            f"{t_sw100*1e3:8.2f}m {t_sw25*1e3:8.2f}m {res['bandwidth_tax']:5.2f}"
        )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="DLRM testbed (PyTorch port)")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    final = train_small_dlrm(device=args.device)
    if not final < 0.6:
        raise SystemExit(f"DLRM training failed to learn: final loss {final}")
    network_study()


if __name__ == "__main__":
    main()
