"""Routing (Algorithm 4 + App. E.3): CoinChangeMod for AllReduce rings,
k-shortest-path for MP transfers, and host-based-forwarding accounting
(bandwidth tax, §5.4/§5.5).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import networkx as nx
import numpy as np


@dataclass
class Route:
    """A multi-hop path: node sequence src..dst (len >= 2)."""

    path: tuple[int, ...]

    @property
    def hops(self) -> int:
        return len(self.path) - 1


@dataclass
class RoutingTable:
    """Routes between node pairs.  Multiple routes per pair allowed
    (host-based forwarding load-balances across them)."""

    routes: dict[tuple[int, int], list[Route]] = field(default_factory=dict)

    def add(self, src: int, dst: int, path: tuple[int, ...]) -> None:
        self.routes.setdefault((src, dst), []).append(Route(path=path))

    def get(self, src: int, dst: int) -> list[Route]:
        return self.routes.get((src, dst), [])


def coin_change_mod(n: int, strides: list[int]) -> dict[int, list[int]]:
    """Algorithm 4.  For every node distance m in [1, n-1], find the minimal
    multiset of "coins" (selected ring strides) summing to m (mod n).

    Returns {m: [coin, coin, ...]} — the back-trace of coins; hopping
    coin-by-coin from src yields the route.  BFS over Z_n (uniform coin cost)
    is equivalent to the paper's DP and O(n * |coins|).
    """
    if n <= 1:
        return {}
    coins = sorted(set(strides))
    bt: dict[int, list[int]] = {0: []}
    frontier = [0]
    while frontier:
        nxt = []
        for v in frontier:
            for c in coins:
                w = (v + c) % n
                if w not in bt:
                    bt[w] = bt[v] + [c]
                    nxt.append(w)
        frontier = nxt
    bt.pop(0, None)
    return bt


def allreduce_routes(members: tuple[int, ...], strides: list[int]) -> RoutingTable:
    """Routes for every ordered pair of an AllReduce group over its stride
    rings (coin-change in group-local index space, App. E.3)."""
    n = len(members)
    table = RoutingTable()
    bt = coin_change_mod(n, strides)
    for i in range(n):
        for m, coin_seq in bt.items():
            j = (i + m) % n
            path = [i]
            for c in coin_seq:
                path.append((path[-1] + c) % n)
            table.add(members[i], members[j], tuple(members[v] for v in path))
    return table


def k_shortest_mp_routes(
    graph: nx.MultiDiGraph, mp: np.ndarray, k: int = 2
) -> RoutingTable:
    """k-shortest-path routing for MP transfers on the *combined* topology
    (Algorithm 1, line 20)."""
    table = RoutingTable()
    simple = nx.DiGraph(graph)  # collapse parallel links for path search
    srcs, dsts = np.nonzero(mp)
    for s, t in zip(srcs.tolist(), dsts.tolist()):
        if s == t:
            continue
        try:
            gen = nx.shortest_simple_paths(simple, s, t)
            best_len = None
            for idx, path in enumerate(gen):
                if best_len is None:
                    best_len = len(path)
                elif len(path) > best_len + 1:
                    break  # only near-shortest alternates
                table.add(s, t, tuple(path))
                if idx + 1 >= k:
                    # Stop before asking Yen's generator for the (k+1)-th
                    # path — it would compute (and discard) the most
                    # expensive spur sweep of the whole pair.
                    break
        except nx.NetworkXNoPath:
            continue
    return table


# ---------------------------------------------------------------------------
# Host-based forwarding accounting (§5.4, §5.5)
# ---------------------------------------------------------------------------


def _flow_triples(flows):
    """Iterate ``(src, dst, nbytes)`` from either a legacy list of tuples
    or the array-backed :class:`repro_torch.core.netsim.Flows` — lazily, without
    materializing an intermediate tuple list."""
    src = getattr(flows, "src", None)
    if src is not None:
        return zip(src.tolist(), flows.dst.tolist(), flows.nbytes.tolist())
    return iter(flows)


def link_loads(
    graph: nx.MultiDiGraph,
    demand_flows,
    routing: RoutingTable,
) -> dict[tuple[int, int], float]:
    """Bytes carried by each directed link (parallel links between a pair
    share load evenly) when flows follow ``routing`` with equal splitting
    across the available routes of a pair.  ``demand_flows`` is a list of
    ``(src, dst, nbytes)`` tuples or a :class:`repro_torch.core.netsim.Flows`."""
    loads: dict[tuple[int, int], float] = {}
    n_par: dict[tuple[int, int], int] = {}
    for u, v, _ in graph.edges(keys=True):
        n_par[(u, v)] = n_par.get((u, v), 0) + 1
        loads.setdefault((u, v), 0.0)
    for src, dst, nbytes in _flow_triples(demand_flows):
        routes = routing.get(src, dst)
        if not routes:
            continue
        share = nbytes / len(routes)
        for r in routes:
            for a, b in zip(r.path[:-1], r.path[1:]):
                loads[(a, b)] = loads.get((a, b), 0.0) + share
    return loads


def bandwidth_tax(demand_flows, routing: RoutingTable) -> float:
    """Ratio of bytes placed on the wire (including forwarded copies) to the
    logical demand (§5.4).  Fat-tree tax == 1 by definition.
    ``demand_flows`` is a list of tuples or a
    :class:`repro_torch.core.netsim.Flows` (summed without tuple round-trips)."""
    if hasattr(demand_flows, "total"):
        logical = demand_flows.total
    else:
        logical = sum(b for _, _, b in demand_flows)
    if logical <= 0:
        return 1.0
    wire = 0.0
    for src, dst, nbytes in _flow_triples(demand_flows):
        routes = routing.get(src, dst)
        if not routes:
            wire += nbytes  # unroutable ~ direct (shouldn't happen on connected G)
            continue
        share = nbytes / len(routes)
        wire += sum(share * r.hops for r in routes)
    return wire / logical


def path_length_stats(routing: RoutingTable) -> dict[str, float]:
    """CDF-style stats over per-pair best path length (Fig. 14)."""
    lens = [min(r.hops for r in rs) for rs in routing.routes.values() if rs]
    if not lens:
        return {"mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    arr = np.asarray(lens, dtype=np.float64)
    return {
        "mean": float(arr.mean()),
        "p50": float(np.percentile(arr, 50)),
        "p99": float(np.percentile(arr, 99)),
        "max": float(arr.max()),
    }
