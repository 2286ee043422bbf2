"""Interconnect cost model (§5.2, Appendix G, Table 2).

Component prices (USD) are the paper's Table 2 values.  Fiber cost: $0.3/m,
length ~ U(0, 1000) m -> expected $150/fiber.  TopoOpt uses 2d patch-panel
ports per server (Active + Look-ahead, App. C) and d 1x2 mechanical switches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# Table 2 (per-port / per-device prices at each link rate).
TABLE2 = {
    10e9: dict(transceiver=20, nic=185, sw_port=94),
    25e9: dict(transceiver=39, nic=185, sw_port=144),
    40e9: dict(transceiver=39, nic=354, sw_port=144),
    100e9: dict(transceiver=99, nic=678, sw_port=187),
    200e9: dict(transceiver=198, nic=815, sw_port=374),
}
PATCH_PANEL_PORT = 100.0
OCS_PORT = 520.0
SWITCH_1X2 = 25.0
EXPECTED_FIBER = 0.3 * 500.0  # $/m * E[U(0,1000)]

# -- Churn pricing (online re-optimization) ---------------------------------
# A replan does not pay a flat reconfiguration fee: the patch panel moves
# each *changed* fiber individually.  Robotic patch panels need seconds per
# move (scheduler.PATCH_PANEL_RECONFIG_S ~ 120 s for a full n*d ~ 64-fiber
# rebuild); an OCS-backed fabric amortizes its RECONFIG_LATENCY (10 ms)
# across a typical 16-circuit swing.
FIBER_MOVE_S = 2.0  # robotic patch panel, seconds per moved fiber
OCS_FIBER_MOVE_S = 10e-3 / 16  # OCS port retarget, seconds per moved fiber
FIBER_MOVE_WEAR = 0.01  # fraction of port+fiber capex consumed per re-patch


def fiber_move_cost(edges_moved: int) -> float:
    """Operational cost (USD) of re-patching ``edges_moved`` fibers: each
    move touches two patch-panel ports and wears the fiber/connectors by
    ``FIBER_MOVE_WEAR`` of their capex."""
    return edges_moved * FIBER_MOVE_WEAR * (2 * PATCH_PANEL_PORT + EXPECTED_FIBER)


# -- Migration pricing (tenant checkpoint-restore + fiber churn) -------------
# Moving a *running* tenant to a new placement is a checkpoint-restore cycle
# (drain, serialize model state, restore on the new servers, re-establish
# collectives) plus the patch-panel churn of re-seating its fibers.  The
# restore bandwidth is the aggregate parallel-filesystem / object-store rate
# the checkpoint streams at; the restart floor covers process teardown,
# container scheduling, and collective re-initialization.
CHECKPOINT_RESTORE_BW = 10e9  # bytes/s aggregate checkpoint-restore rate
MIGRATION_RESTART_S = 5.0  # per-migration drain/teardown/re-init floor


def migration_cost(
    state_bytes: float,
    edges_moved: int = 0,
    fiber_move_s: float = FIBER_MOVE_S,
    checkpoint_bw: float = CHECKPOINT_RESTORE_BW,
    restart_s: float = MIGRATION_RESTART_S,
) -> float:
    """Seconds of training pause one tenant migration charges: the restart
    floor, the checkpoint-restore transfer of ``state_bytes`` of model
    state (:attr:`repro_torch.core.workloads.JobSpec.state_bytes`), and the
    patch-panel re-seat of ``edges_moved`` fibers
    (:func:`repro.core.online.edge_churn` between the incumbent and the
    post-migration topology)."""
    if state_bytes < 0 or edges_moved < 0:
        raise ValueError("migration_cost needs non-negative inputs")
    return (
        restart_s
        + state_bytes / checkpoint_bw
        + edges_moved * fiber_move_s
    )


def checkpoint_restart_s(
    state_bytes: float,
    checkpoint_bw: float = CHECKPOINT_RESTORE_BW,
    restart_s: float = MIGRATION_RESTART_S,
) -> float:
    """Seconds a *fault-induced* restart pauses a job: reload ``state_bytes``
    of model state from the last checkpoint at ``checkpoint_bw`` plus the
    process-teardown / collective-re-init floor.  This is
    :func:`migration_cost` without the fiber churn term — a job stalled by a
    fabric partition restores in place, it does not re-seat fibers.  Feed
    the result into :attr:`repro_torch.core.simengine.Scenario.restart_s` to price
    partition-survival restarts."""
    if state_bytes < 0:
        raise ValueError("checkpoint_restart_s needs non-negative state_bytes")
    return restart_s + state_bytes / checkpoint_bw


def _table2(link_gbps: float) -> dict:
    key = link_gbps * 1e9
    if key not in TABLE2:
        key = min(TABLE2, key=lambda k: abs(k - link_gbps * 1e9))
    return TABLE2[key]


@dataclass(frozen=True)
class ClusterSpec:
    n_servers: int
    degree: int = 4
    link_gbps: float = 100.0


def topoopt_cost(spec: ClusterSpec, use_ocs: bool = False) -> float:
    """TopoOpt direct-connect: d NICs + d transceivers per server, 2d optical
    ports (look-ahead design) or d OCS ports, d 1x2 switches, d fibers."""
    c = _table2(spec.link_gbps)
    per_server = spec.degree * (c["nic"] + c["transceiver"] + EXPECTED_FIBER)
    if use_ocs:
        per_server += spec.degree * OCS_PORT
    else:
        per_server += 2 * spec.degree * PATCH_PANEL_PORT + spec.degree * SWITCH_1X2
    return spec.n_servers * per_server


def _fat_tree_ports(n_endpoints: int) -> tuple[int, int]:
    """(#switch ports, k) for the smallest k-ary full-bisection fat-tree
    hosting n endpoints: k^3/4 hosts, 5k^2/4 switches of k ports."""
    k = 2
    while k**3 / 4 < n_endpoints:
        k += 2
    n_switches = 5 * k * k // 4
    return n_switches * k, k


def fat_tree_cost(
    spec: ClusterSpec,
    bandwidth_fraction: float = 1.0,
    oversub: float = 1.0,
    parallel_links: bool = False,
) -> float:
    """Full-bisection k-ary fat-tree baselines (§5.1/§5.2, App. G).

    * similar-cost baseline (``parallel_links=False``): one NIC per server at
      rate ``d * B * bandwidth_fraction`` -> n endpoints; the fraction is
      tuned until the cost matches TopoOpt.
    * Ideal Switch (``parallel_links=True``): d*B per server built from d
      parallel B-rate links on commodity gear -> n*d endpoints at rate B
      (2022 gear has no (d*B)-rate single port at these d*B values).
    ``oversub`` > 1 removes that fraction of the non-host-facing ports.
    """
    if parallel_links:
        endpoints = spec.n_servers * spec.degree
        rate = spec.link_gbps * bandwidth_fraction
        nics_per_server = spec.degree
    else:
        endpoints = spec.n_servers
        rate = spec.link_gbps * spec.degree * bandwidth_fraction
        nics_per_server = 1
    c = _table2(rate)
    # price rates above Table 2's ceiling as bundles of 100G components
    scale = max(1.0, rate / 200.0) if rate > 200 else 1.0
    ports, _ = _fat_tree_ports(endpoints)
    core_ports = ports - endpoints
    ports = endpoints + math.ceil(core_ports / oversub)
    cost = spec.n_servers * nics_per_server * (
        scale * (c["nic"] + c["transceiver"]) + EXPECTED_FIBER
    )
    # every switch port carries a transceiver; half the fiber per port.
    cost += ports * (scale * (c["sw_port"] + c["transceiver"]) + EXPECTED_FIBER / 2)
    return cost


def ideal_switch_cost(spec: ClusterSpec) -> float:
    return fat_tree_cost(spec, bandwidth_fraction=1.0, parallel_links=True)


def expander_cost(spec: ClusterSpec) -> float:
    """Static direct-connect: d NICs/transceivers/fibers, no optical layer."""
    c = _table2(spec.link_gbps)
    return spec.n_servers * spec.degree * (c["nic"] + c["transceiver"] + EXPECTED_FIBER)


def sipml_cost(spec: ClusterSpec) -> float:
    """SiP-ML: d wavelengths/GPU on silicon-photonic fabric.  SiP ports are
    not commercial; the paper's Fig. 10 places SiP-ML as the most expensive —
    we price its ports at the OCS rate x2 (comb laser + MRR filters) plus
    Tbps-class NICs."""
    c = _table2(spec.link_gbps)
    per = spec.degree * (c["nic"] + 2 * OCS_PORT + c["transceiver"] + EXPECTED_FIBER)
    return spec.n_servers * per


def cost_equivalent_bandwidth_fraction(spec: ClusterSpec) -> float:
    """Find B'/B such that fat_tree_cost(B') ~= topoopt_cost (the paper's
    similar-cost Fat-tree baseline, §5.1)."""
    target = topoopt_cost(spec)
    lo, hi = 0.05, 1.0
    for _ in range(40):
        mid = (lo + hi) / 2
        if fat_tree_cost(spec, bandwidth_fraction=mid) > target:
            hi = mid
        else:
            lo = mid
    return (lo + hi) / 2


def cost_report(spec: ClusterSpec) -> dict[str, float]:
    return {
        "topoopt_patch": topoopt_cost(spec, use_ocs=False),
        "topoopt_ocs": topoopt_cost(spec, use_ocs=True),
        "fat_tree_similar_cost": fat_tree_cost(
            spec, bandwidth_fraction=cost_equivalent_bandwidth_fraction(spec)
        ),
        "oversub_fat_tree": fat_tree_cost(spec, oversub=2.0, parallel_links=True),
        "ideal_switch": ideal_switch_cost(spec),
        "expander": expander_cost(spec),
        "sipml": sipml_cost(spec),
    }
