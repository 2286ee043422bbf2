"""Baseline fabrics simulated in §5: expander, SiP-ML ring, and helpers to
evaluate any direct-connect graph with the same fluid model as TopoOpt.
"""

from __future__ import annotations

import networkx as nx
import numpy as np

from .demand import TrafficDemand
from .netsim import HardwareSpec, _ring_bytes_per_link, mp_flows
from .routing import RoutingTable, link_loads
from .topology_finder import Topology


def _all_pairs_shortest_routing(graph: nx.MultiDiGraph) -> RoutingTable:
    table = RoutingTable()
    simple = nx.DiGraph(graph)
    for src, paths in nx.all_pairs_shortest_path(simple):
        for dst, path in paths.items():
            if src != dst:
                table.add(src, dst, tuple(path))
    return table


def expander_topology(n: int, degree: int, seed: int = 0) -> Topology:
    """Jellyfish/Xpander-style random regular direct-connect graph."""
    und = nx.random_regular_graph(degree, n, seed=seed)
    g = nx.MultiDiGraph()
    g.add_nodes_from(range(n))
    for a, b in und.edges():
        g.add_edge(a, b, kind="mp")
        g.add_edge(b, a, kind="mp")
    topo = Topology(n=n, degree=degree, graph=g, d_allreduce=0, d_mp=degree)
    topo.routing = _all_pairs_shortest_routing(g)
    return topo


def sipml_ring_topology(n: int, degree: int) -> Topology:
    """SiP-ML SiP-Ring-like physical ring: node i connects to i±1 ... i±d/2
    (wavelengths around a ring)."""
    g = nx.MultiDiGraph()
    g.add_nodes_from(range(n))
    half = max(1, degree // 2)
    for i in range(n):
        for off in range(1, half + 1):
            g.add_edge(i, (i + off) % n, kind="mp")
            g.add_edge(i, (i - off) % n, kind="mp")
    topo = Topology(n=n, degree=degree, graph=g, d_allreduce=0, d_mp=degree)
    topo.routing = _all_pairs_shortest_routing(g)
    return topo


def generic_comm_time(
    topo: Topology, demand: TrafficDemand, hw: HardwareSpec
) -> float:
    """Fluid comm time for a fixed (non-TopoOpt) direct-connect fabric:
    AllReduce rides a logical ring embedded via the routing table (no
    mutability optimization), MP follows shortest paths."""
    loads: dict[tuple[int, int], float] = {}

    for group in demand.allreduce:
        k = len(group.members)
        per_link = _ring_bytes_per_link(group.nbytes, k)
        if per_link == 0.0:
            continue
        # Default (stride-1) ring embedded on the fabric via routing.
        for idx in range(k):
            a = group.members[idx]
            b = group.members[(idx + 1) % k]
            routes = topo.routing.get(a, b)
            if not routes:
                continue
            share = per_link / len(routes)
            for r in routes:
                for u, v in zip(r.path[:-1], r.path[1:]):
                    loads[(u, v)] = loads.get((u, v), 0.0) + share

    flows = mp_flows(demand)
    for link, nbytes in link_loads(topo.graph, flows, topo.routing).items():
        loads[link] = loads.get(link, 0.0) + nbytes

    n_par: dict[tuple[int, int], int] = {}
    for a, b in topo.graph.edges():
        n_par[(a, b)] = n_par.get((a, b), 0) + 1
    worst = 0.0
    for link, nbytes in loads.items():
        worst = max(worst, nbytes / (max(1, n_par.get(link, 1)) * hw.link_bandwidth))
    return worst
