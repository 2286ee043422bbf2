"""Quickstart in the port: co-optimize topology + parallelization for a DLRM
job, then inspect the TopoOpt plan; the twin of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart

The strategy search runs on the card (``backend="torch"``, the port's
default), and raises without one.  ``main(backend="numpy")`` runs the host
walk instead, which equals the JAX package's default backend to the bit, so
its output equals the example's line for line.
"""

from __future__ import annotations

from repro_torch.core import HardwareSpec, alternating_optimize
from repro_torch.core.simengine import (
    fat_tree_comm_time,
    ideal_switch_comm_time,
    topoopt_comm_time,
)
from repro_torch.core.topology_finder import effective_diameter
from repro_torch.core.workloads import DLRM


def main(*, backend: str = "torch") -> None:
    n, degree = 16, 4
    hw = HardwareSpec(link_bandwidth=100e9 / 8, degree=degree)

    print(f"Co-optimizing DLRM on {n} servers, degree {degree}, 100 Gbps ...")
    res = alternating_optimize(DLRM, n=n, hw=hw, rounds=3, mcmc_iters=150, seed=0,
                               backend=backend)

    print(f"\nstrategy: {res.strategy.mode}")
    if res.strategy.table_hosts:
        print(f"embedding-table hosts: {res.strategy.table_hosts}")
    print(f"estimated iteration time: {res.iter_time * 1e3:.2f} ms")

    topo = res.topology
    print(f"\ntopology: d_AllReduce={topo.d_allreduce} d_MP={topo.d_mp}")
    for members, rings in topo.rings.items():
        print(f"  AllReduce group of {len(members)}: strides "
              f"{[r.p for r in rings]} (TotientPerms)")
    print(f"  effective diameter: {effective_diameter(topo)}")

    t = topoopt_comm_time(topo, res.demand, hw)
    print(f"  comm time: {t['comm_time']*1e3:.2f} ms, "
          f"bandwidth tax: {t['bandwidth_tax']:.2f}")

    t_ideal = ideal_switch_comm_time(res.demand, hw)
    t_ft = fat_tree_comm_time(res.demand, hw, bandwidth_fraction=0.35)
    print(f"\nvs ideal switch : {t['comm_time'] / t_ideal:.2f}x its comm time")
    print(f"vs similar-cost fat-tree: {t_ft / t['comm_time']:.2f}x faster")


if __name__ == "__main__":
    main()
