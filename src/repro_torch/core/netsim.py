"""Fluid bottleneck-link comm-time model (§5.1, FlexNet analogue).

The preferred entry point is :class:`repro_torch.core.simengine.SimEngine`, which
re-exports everything here and unifies the three simulation granularities
(fluid analysis, event-driven max-min-fair flows, scenario runs with
arrivals / failures / OCS reconfiguration).  Importing the subsumed entry
points (``topoopt_comm_time``, ``ideal_switch_comm_time``,
``fat_tree_comm_time``, ``iteration_time``) from *this* module emits a
:class:`DeprecationWarning`; the same names are warning-free on
``repro_torch.core.simengine``.  This module keeps the fluid primitives
themselves:

* ``topoopt_comm_time`` — every flow follows its routes, link loads
  accumulate, comm time = max link (bytes / bandwidth); AllReduce groups
  ride their permutation rings with the canonical ring cost
  ``2 (k-1)/k * M`` split over the group's rings.
* ``ideal_switch_comm_time`` / ``fat_tree_comm_time`` — §5.1 baselines.

Fabrics other than TopoOpt (expander, SiP-ML ring) are built in
:mod:`repro.core.fabrics` and consumed here through the same interface.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from .demand import TrafficDemand, demand_steps
from .routing import bandwidth_tax, link_loads
from .topology_finder import Topology


@dataclass(frozen=True)
class HardwareSpec:
    """Per-node network/compute capability."""

    link_bandwidth: float = 100e9 / 8  # bytes/s per interface (100 Gbps NIC)
    degree: int = 4
    compute_flops: float = 312e12  # A100 bf16 peak
    compute_efficiency: float = 0.45
    # α of the (α, β) collective cost model: per-round link latency (s).
    # 0.0 keeps the pure fluid model (and every pre-schedule result)
    # bit-identical; set it to price latency-dominated schedules
    # (repro_torch.core.schedules) against bandwidth-optimal rings.
    link_latency: float = 0.0

    @property
    def node_bandwidth(self) -> float:
        return self.link_bandwidth * self.degree


def _ring_bytes_per_link(group_bytes: float, k: int) -> float:
    """Ring AllReduce moves 2*(k-1)/k * M across each link of the ring."""
    if k <= 1:
        return 0.0
    return 2.0 * (k - 1) / k * group_bytes


class Flows:
    """A demand's MP flows as parallel arrays (``src``, ``dst``,
    ``nbytes``) — no per-element tuple materialization.  Iterating yields
    ``(src, dst, nbytes)`` triples for legacy consumers."""

    __slots__ = ("src", "dst", "nbytes")

    def __init__(self, src: np.ndarray, dst: np.ndarray, nbytes: np.ndarray):
        self.src = src
        self.dst = dst
        self.nbytes = nbytes

    def __len__(self) -> int:
        return int(self.src.size)

    def __iter__(self):
        return zip(self.src.tolist(), self.dst.tolist(), self.nbytes.tolist())

    @property
    def total(self) -> float:
        return float(self.nbytes.sum())


def mp_flows(demand: TrafficDemand) -> Flows:
    """Nonzero MP entries, vectorized (one ``np.nonzero`` + one gather)."""
    srcs, dsts = np.nonzero(demand.mp)
    return Flows(srcs, dsts, demand.mp[srcs, dsts])


def _topoopt_comm_time(
    topo: Topology, demand: TrafficDemand, hw: HardwareSpec
) -> dict[str, float]:
    """Fluid comm time on a TopoOpt direct-connect topology.

    AllReduce bytes are spread over each group's rings (multi-ring
    load-balancing, §6); MP bytes follow the routing table with host-based
    forwarding (bandwidth tax).  Both share the physical links.

    This is the *reference* implementation.  The search loops run on the
    compiled fast path (:func:`repro_torch.core.planeval.plan_evaluator`), which
    must agree with this function to 1e-9 relative — keep the two in sync.
    """
    loads, flows, routing = _reference_loads(topo, demand)
    worst = _reference_worst(topo, loads, hw)
    if hw.link_latency:
        worst = worst + hw.link_latency * demand_steps(demand)
    tax = bandwidth_tax(flows, routing) if flows else 1.0
    return {"comm_time": worst, "bandwidth_tax": tax}


def reference_comm_time(
    topo: Topology, demand: TrafficDemand, hw: HardwareSpec
) -> float:
    """The ``comm_time`` of :func:`topoopt_comm_time`, bit-identical,
    without paying for the bandwidth tax — the search loops' reference
    objective (and the compiled path's tie-breaking authority)."""
    loads, _, _ = _reference_loads(topo, demand)
    worst = _reference_worst(topo, loads, hw)
    if hw.link_latency:
        worst = worst + hw.link_latency * demand_steps(demand)
    return worst


def _reference_loads(topo: Topology, demand: TrafficDemand):
    loads: dict[tuple[int, int], float] = {}

    # AllReduce traffic on its rings (chunked across rings).
    for group in demand.allreduce:
        rings = topo.rings.get(group.members, [])
        k = len(group.members)
        per_link_total = _ring_bytes_per_link(group.nbytes, k)
        if not rings or per_link_total == 0.0:
            continue
        share = per_link_total / len(rings)
        for ring in rings:
            for a, b in ring.edges():
                loads[(a, b)] = loads.get((a, b), 0.0) + share

    # MP traffic over routed paths (forwarding copies count on every hop).
    # Pairs without a precomputed route (e.g. MCMC probing placements on a
    # fixed topology) fall back to shortest-path on the current graph.
    flows = mp_flows(demand)
    routing = _routing_with_fallback(topo, flows)
    mp_loads = link_loads(topo.graph, flows, routing)
    for link, nbytes in mp_loads.items():
        loads[link] = loads.get(link, 0.0) + nbytes
    return loads, flows, routing


def _reference_worst(topo: Topology, loads, hw: HardwareSpec) -> float:
    # Parallel links between the same pair share the load.
    n_par: dict[tuple[int, int], int] = {}
    for a, b in topo.graph.edges():
        n_par[(a, b)] = n_par.get((a, b), 0) + 1
    worst = 0.0
    for link, nbytes in loads.items():
        par = max(1, n_par.get(link, 1))
        worst = max(worst, nbytes / (par * hw.link_bandwidth))
    return worst


def _routing_with_fallback(topo: Topology, flows) -> "RoutingTable":
    """Routing table covering every flow pair: the planned table, extended
    with shortest-path fallbacks for pairs the plan never routed (MCMC
    probing placements on a fixed topology).

    Fallback routes persist on the topology (``topo._sp_cache``) together
    with one memoized *merged* table (``topo._merged_routing``) — on a full
    cache hit nothing is copied, the memoized table is returned as-is, and
    the planned table is returned untouched when no pair needs a fallback.
    """
    routing = topo.routing
    cache = getattr(topo, "_sp_cache", None)
    missing_any = False
    need: list[tuple[int, int]] = []
    for s, t, _ in flows:
        if routing.get(s, t):
            continue
        missing_any = True
        if cache is None or (s, t) not in cache:
            need.append((s, t))
    if not missing_any:
        return routing
    if cache is None:
        from .routing import RoutingTable

        cache = {}
        topo._sp_cache = cache
        topo._merged_routing = RoutingTable(routes=dict(routing.routes))
    merged = topo._merged_routing
    if need:
        import networkx as nx

        simple = getattr(topo, "_simple_digraph", None)
        if simple is None:
            simple = nx.DiGraph(topo.graph)
            topo._simple_digraph = simple
        for s, t in need:
            if (s, t) in cache:
                continue  # duplicate pair in this flow list
            try:
                path = tuple(nx.shortest_path(simple, s, t))
                merged.add(s, t, path)
                cache[(s, t)] = merged.routes[(s, t)]
            except (nx.NetworkXNoPath, nx.NodeNotFound):
                cache[(s, t)] = []
    return merged


def _ideal_switch_comm_time(demand: TrafficDemand, hw: HardwareSpec) -> float:
    """Ideal non-blocking switch with node bandwidth d*B (§5.1): AllReduce at
    full node bandwidth + per-node in/out bottleneck for MP."""
    t = 0.0
    for group in demand.allreduce:
        k = len(group.members)
        t = max(t, _ring_bytes_per_link(group.nbytes, k) / hw.node_bandwidth)
    out_bytes = demand.mp.sum(axis=1)
    in_bytes = demand.mp.sum(axis=0)
    node_bottleneck = max(out_bytes.max(initial=0.0), in_bytes.max(initial=0.0))
    return max(t, t + node_bottleneck / hw.node_bandwidth)


def _fat_tree_comm_time(
    demand: TrafficDemand, hw: HardwareSpec, bandwidth_fraction: float
) -> float:
    """Cost-equivalent fat-tree: one NIC per server with d*B' bandwidth where
    B' = bandwidth_fraction * B (§5.1/§5.2); full-bisection so it behaves as
    an ideal switch at the reduced rate."""
    scaled = HardwareSpec(
        link_bandwidth=hw.link_bandwidth * bandwidth_fraction,
        degree=hw.degree,
        compute_flops=hw.compute_flops,
        compute_efficiency=hw.compute_efficiency,
        link_latency=hw.link_latency,
    )
    return _ideal_switch_comm_time(demand, scaled)


def _iteration_time(
    comm_time: float,
    compute_time: float,
    overlap: float = 0.0,
) -> float:
    """Combine compute and comm.  ``overlap`` in [0,1]: fraction of comm that
    hides under compute (the paper's Eq. 1 uses overlap=0)."""
    hidden = min(comm_time * overlap, compute_time)
    return compute_time + comm_time - hidden


def compute_time(flops_per_iteration: float, n: int, hw: HardwareSpec) -> float:
    return flops_per_iteration / (n * hw.compute_flops * hw.compute_efficiency)


# -- deprecated shim surface -------------------------------------------------
# The scenario engine subsumed these entry points; they stay importable
# here for compatibility but warn.  Warning-free homes:
# ``repro_torch.core.simengine.<name>`` (or ``SimEngine.comm_time`` /
# ``SimEngine.iteration_time`` for the fluid facade).

_DEPRECATED_SHIMS = {
    "topoopt_comm_time": _topoopt_comm_time,
    "ideal_switch_comm_time": _ideal_switch_comm_time,
    "fat_tree_comm_time": _fat_tree_comm_time,
    "iteration_time": _iteration_time,
}


def __getattr__(name: str):
    shim = _DEPRECATED_SHIMS.get(name)
    if shim is not None:
        warnings.warn(
            f"repro_torch.core.netsim.{name} is deprecated; import it from "
            "repro_torch.core.simengine (or use SimEngine) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        return shim
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
