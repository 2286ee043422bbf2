"""TopologyFinder (paper Algorithm 1, §4.2) + failure handling (§7).

Given ``n`` servers of degree ``d`` and a :class:`TrafficDemand`, construct:

1. degree split ``d_A``/``d_MP`` proportional to AllReduce vs MP bytes
   (Alg. 1 line 2: ``d_A = max(1, ceil(d * sum_AR / (sum_AR + sum_MP)))``),
2. the AllReduce sub-topology — ``d_k`` TotientPerms rings per group chosen
   by SelectPermutations (geometric-stride, small diameter; Alg. 2/3 in
   :mod:`repro_torch.core.totient` / :mod:`repro_torch.core.select_perms`),
3. the MP sub-topology — repeated Blossom max-weight matching with
   demand-halving (diminishing returns, App. E.4 Discount),
4. combined topology + routing: CoinChangeMod (Alg. 4,
   :mod:`repro_torch.core.routing`) on the ring strides for AllReduce,
   k-shortest-path on the combined graph for MP.

Notation mapping (paper -> code): ``d`` -> ``degree``, ``d_A`` ->
``Topology.d_allreduce``, ``d_MP`` -> ``Topology.d_mp``, ``d_k`` (per-group
ring budget) -> computed per :class:`AllReduceGroup` from its byte share,
``T_MP`` -> ``TrafficDemand.mp``, the permutation set ``P`` ->
:class:`repro_torch.core.totient.PermutationSet`.

Two degradation paths serve the failure story:

* :func:`repair_topology` — the paper's §7 quick fix for a cut *fiber*:
  donate the lowest-value MP link to close a broken AllReduce ring and
  re-route around the cut (the pair itself may be re-patched).
* :func:`remove_pair` — a dead node *pair* (port/transceiver loss): both
  directions disappear for good; :mod:`repro.core.online` keeps this as the
  static operator's incumbent and passes the same pairs to
  ``topology_finder(forbidden=...)`` when re-optimizing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable

import networkx as nx
import numpy as np

from .demand import AllReduceGroup, TrafficDemand
from .routing import RoutingTable, allreduce_routes, k_shortest_mp_routes
from .select_perms import coin_change_diameter, select_permutations
from .totient import PermutationSet, RingPermutation, totient_perms


@dataclass
class Topology:
    """The physical plan for one job's shard of the cluster."""

    n: int
    degree: int
    graph: nx.MultiDiGraph
    # AllReduce group -> the ring permutations (strides) carrying it.
    rings: dict[tuple[int, ...], list[RingPermutation]] = field(default_factory=dict)
    routing: RoutingTable = field(default_factory=RoutingTable)
    d_allreduce: int = 0
    d_mp: int = 0

    def ring_strides(self, members: tuple[int, ...]) -> list[int]:
        return [r.p for r in self.rings.get(members, [])]

    def diameter(self) -> int:
        simple = nx.DiGraph(self.graph)
        if simple.number_of_nodes() < self.n or not nx.is_strongly_connected(simple):
            return -1
        return nx.diameter(simple)

    def out_degrees(self) -> list[int]:
        return [self.graph.out_degree(v) for v in range(self.n)]


def _add_ring(graph: nx.MultiDiGraph, ring: RingPermutation) -> None:
    for a, b in ring.edges():
        graph.add_edge(a, b, kind="allreduce", stride=ring.p)


def _add_duplex(graph: nx.MultiDiGraph, a: int, b: int) -> None:
    graph.add_edge(a, b, kind="mp")
    graph.add_edge(b, a, kind="mp")


def _norm_pair(a: int, b: int) -> tuple[int, int]:
    return (a, b) if a <= b else (b, a)


def _select_group_rings(
    g: AllReduceGroup,
    d_k: int,
    forb: set[tuple[int, int]],
    warm_start: Topology | None,
    prime_only: bool | None,
) -> list[RingPermutation]:
    """Pick up to ``d_k`` ring permutations for one AllReduce group:
    warm-start strides first, SelectPermutations for the remainder,
    parallel-copy refill when ``forb`` thinned the set below budget."""
    perm_set = totient_perms(g.members, prime_only=prime_only)
    if forb:
        perm_set = PermutationSet(
            group=perm_set.group,
            perms=[
                r
                for r in perm_set.perms
                if not any(_norm_pair(a, b) in forb for a, b in r.edges())
            ],
        )
    chosen: list[RingPermutation] = []
    if warm_start is not None:
        # Keep incumbent strides that are still valid (warm start).
        still = {r.p: r for r in perm_set.perms}
        for r in warm_start.rings.get(g.members, []):
            if r.p in still and len(chosen) < d_k:
                chosen.append(still[r.p])
    if len(chosen) < d_k:
        rest = PermutationSet(
            group=perm_set.group,
            perms=[r for r in perm_set.perms if r not in chosen],
        )
        chosen = chosen + select_permutations(rest, d_k - len(chosen))
    if forb and chosen and len(chosen) < d_k:
        # Replanning on a degraded fabric: the forbidden pairs thinned
        # the permutation set below the ring budget.  Refill with
        # parallel copies of the surviving strides — on a max-min-fair
        # fabric a second ring of the same stride doubles that ring's
        # capacity, which beats leaving NIC ports dark.
        base = list(chosen)
        while len(chosen) < d_k:
            chosen.append(base[(len(chosen) - len(base)) % len(base)])
    if not chosen and len(g.members) >= 2:
        chosen = [perm_set.perms[0]] if perm_set.perms else []
    return chosen


def topology_finder(
    demand: TrafficDemand,
    degree: int,
    prime_only: bool | None = None,
    mp_route_k: int = 2,
    forbidden: Iterable[tuple[int, int]] = (),
    warm_start: Topology | None = None,
    pack: str = "global",
) -> Topology:
    """Algorithm 1 (paper §4.2).

    ``forbidden`` is a set of node pairs (either direction) that physically
    cannot carry a link — e.g. fiber pairs that failed mid-run.  Ring
    permutations crossing a forbidden pair are excluded from SelectPermutations
    and the Blossom matching skips those pairs, so the returned topology is
    realizable on the surviving fabric.

    ``warm_start`` seeds the ring selection from an incumbent topology
    (online re-optimization): strides the incumbent already uses for a group
    are kept when still valid, and only the remainder of the degree budget is
    re-searched.  This both converges faster and minimizes physical link
    churn when the plan is swapped on a live OCS/patch-panel fabric.

    ``pack`` selects the degree accounting.  ``"global"`` (default) is the
    paper's single-job Algorithm 1: one global ``d_A``/``d_MP`` split and a
    shared ring budget across groups — byte-identical to the pre-multi-tenant
    behaviour.  ``"per_node"`` charges the budget where links actually land
    (a node only spends degree on rings/MP links it terminates), so the
    disjoint per-job groups of a multi-tenant union demand each get their own
    ring budget instead of splitting one global count — this is how per-job
    ring budgets pack into the shared physical degree.
    """
    if pack not in ("global", "per_node"):
        raise ValueError(f"unknown pack mode {pack!r}")
    n = demand.n
    forb = {_norm_pair(a, b) for a, b in forbidden}
    graph = nx.MultiDiGraph()
    graph.add_nodes_from(range(n))

    sum_ar = demand.sum_allreduce
    sum_mp = demand.sum_mp
    total = sum_ar + sum_mp

    groups = list(demand.allreduce)
    if not groups:
        # Keep the network connected even for pure-MP jobs: a zero-traffic
        # global ring still gets the mandatory 1 degree (line 2: max(1, .)).
        groups = [AllReduceGroup(members=tuple(range(n)), nbytes=0.0)]
        sum_ar = 0.0

    # -- Step 1: distribute the degree -------------------------------------
    if total <= 0:
        d_a = 1
    else:
        d_a = max(1, math.ceil(degree * sum_ar / total))
    d_a = min(d_a, degree)
    d_mp = degree - d_a

    rings: dict[tuple[int, ...], list[RingPermutation]] = {}
    if pack == "global":
        # -- Step 2: AllReduce sub-topology ---------------------------------
        d_a_budget = d_a
        group_total = sum(g.total for g in groups)
        for g in sorted(groups, key=lambda g: -g.total):
            if d_a_budget <= 0:
                break
            if group_total > 0:
                d_k = math.ceil(d_a * g.total / group_total)
            else:
                d_k = 1
            d_k = min(d_k, d_a_budget)
            chosen = _select_group_rings(g, d_k, forb, warm_start, prime_only)
            for ring in chosen:
                _add_ring(graph, ring)
            rings[g.members] = chosen
            d_a_budget -= max(len(chosen), 1)

        # -- Step 3: MP sub-topology (Blossom matching, demand halving) -----
        t_mp = demand.mp.copy()
        for _ in range(d_mp):
            sym = t_mp + t_mp.T
            if sym.max() <= 0:
                break
            und = nx.Graph()
            srcs, dsts = np.nonzero(sym)
            for i, j in zip(srcs.tolist(), dsts.tolist()):
                if i < j and (i, j) not in forb:
                    und.add_edge(i, j, weight=float(sym[i, j]))
            matching = nx.max_weight_matching(und, maxcardinality=False)
            if not matching:
                break
            for a, b in matching:
                _add_duplex(graph, a, b)
                # Diminishing return: halve served demand (line 17).
                t_mp[a, b] /= 2.0
                t_mp[b, a] /= 2.0
    else:
        d_a, d_mp = _pack_per_node(
            demand, degree, groups, graph, rings, forb, warm_start, prime_only
        )

    # -- Step 4: final topology + routing ------------------------------------
    topo = Topology(
        n=n, degree=degree, graph=graph, rings=rings,
        d_allreduce=d_a, d_mp=d_mp,
    )
    routing = RoutingTable()
    for members, group_rings in rings.items():
        strides = [r.p for r in group_rings]
        if strides:
            sub = allreduce_routes(members, strides)
            routing.routes.update(sub.routes)
    mp_routes = k_shortest_mp_routes(graph, demand.mp, k=mp_route_k)
    # MP routes take priority on pairs where both exist (shorter on combined G).
    for pair, rs in mp_routes.routes.items():
        existing = routing.routes.get(pair)
        if existing is None or min(r.hops for r in rs) < min(r.hops for r in existing):
            routing.routes[pair] = rs
    topo.routing = routing
    return topo


def _pack_per_node(
    demand: TrafficDemand,
    degree: int,
    groups: list[AllReduceGroup],
    graph: nx.MultiDiGraph,
    rings: dict[tuple[int, ...], list[RingPermutation]],
    forb: set[tuple[int, int]],
    warm_start: Topology | None,
    prime_only: bool | None,
) -> tuple[int, int]:
    """Shared-cluster degree packing: charge the budget per node.

    A ring only consumes one out-port on each of *its* members, and an MP
    duplex only on its two endpoints — so disjoint per-job groups (a
    multi-tenant union demand) each get a full ring budget instead of
    splitting one global count.  Per node ``v`` the AllReduce/MP split of
    Algorithm 1 line 2 is applied to the bytes *terminating at v*; when no
    group spans every node, one port per node is reserved for a zero-byte
    global connectivity ring so idle servers (future arrivals) stay
    reachable.  Returns the ``(d_allreduce, d_mp)`` summary fields.
    """
    n = demand.n
    spans_all = any(set(g.members) == set(range(n)) for g in groups)
    reserve = 0 if spans_all else 1
    if degree - reserve < 1:
        reserve = 0  # degree 1: a connectivity ring would overflow the port
    budget = degree - reserve

    # Per-node byte split: ring bytes a group would put on one of v's ports
    # vs MP bytes terminating at v (a duplex serves both directions).
    per_link = {
        id(g): 2.0 * (len(g.members) - 1) / len(g.members) * g.nbytes
        if len(g.members) > 1
        else 0.0
        for g in groups
    }
    ar_v = np.zeros(n)
    for g in groups:
        for v in g.members:
            ar_v[v] += per_link[id(g)]
    mp_v = (demand.mp.sum(axis=1) + demand.mp.sum(axis=0)) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(ar_v + mp_v > 0, ar_v / (ar_v + mp_v), 1.0)
    d_a_v = np.clip(np.ceil(budget * frac), 1, budget).astype(np.int64)

    used = np.zeros(n, dtype=np.int64)
    for g in sorted(groups, key=lambda g: -g.total):
        members = np.asarray(g.members, dtype=np.int64)
        avail = int((budget - used[members]).min()) if members.size else 0
        if per_link[id(g)] > 0:
            # The group's share of each member's AllReduce budget; the
            # tightest member bounds the ring count.
            share = d_a_v[members] * per_link[id(g)] / ar_v[members]
            d_k = max(1, int(np.ceil(share.min())))
        else:
            d_k = 1 if len(g.members) > 1 else 0
        d_k = min(d_k, avail)
        if avail <= 0:
            chosen = []  # members saturated: even a fallback ring overflows
        else:
            chosen = _select_group_rings(
                g, d_k, forb, warm_start, prime_only
            )[:avail]
        for ring in chosen:
            _add_ring(graph, ring)
        rings[g.members] = chosen
        if members.size:
            used[members] += len(chosen)
    used_ar = used.copy()

    # MP links fill whatever per-node budget remains.
    t_mp = demand.mp.copy()
    for _ in range(degree):
        sym = t_mp + t_mp.T
        if sym.max() <= 0:
            break
        und = nx.Graph()
        srcs, dsts = np.nonzero(sym)
        progress = False
        for i, j in zip(srcs.tolist(), dsts.tolist()):
            if (
                i < j
                and (i, j) not in forb
                and used[i] < budget
                and used[j] < budget
            ):
                und.add_edge(i, j, weight=float(sym[i, j]))
        matching = nx.max_weight_matching(und, maxcardinality=False)
        for a, b in matching:
            _add_duplex(graph, a, b)
            used[a] += 1
            used[b] += 1
            t_mp[a, b] /= 2.0
            t_mp[b, a] /= 2.0
            progress = True
        if not progress:
            break

    if reserve:
        # Zero-byte global connectivity ring on the reserved port: future
        # arrivals (and reroutes around failures) always have a path.
        members = tuple(range(n))
        conn = AllReduceGroup(members=members, nbytes=0.0)
        chosen = _select_group_rings(conn, 1, forb, warm_start, prime_only)
        if chosen:
            _add_ring(graph, chosen[0])
            rings.setdefault(members, [chosen[0]])
    d_allreduce = int(used_ar.max(initial=0)) + reserve
    return d_allreduce, degree - d_allreduce


def effective_diameter(topo: Topology) -> int:
    """Diameter as seen by coin-change routing on the primary AllReduce group
    (Theorem 1's quantity), falling back to the graph diameter."""
    if topo.rings:
        members, group_rings = max(topo.rings.items(), key=lambda kv: len(kv[0]))
        strides = [r.p for r in group_rings]
        if strides:
            return coin_change_diameter(len(members), strides)
    return topo.diameter()


# ---------------------------------------------------------------------------
# Failure handling (§7 "Handling failures")
# ---------------------------------------------------------------------------


def repair_topology(topo: Topology, failed: tuple[int, int]) -> Topology:
    """A fiber failure removes links between ``failed=(u, v)`` (both
    directions).  Per §7: TopoOpt donates an MP link to restore a broken
    AllReduce ring; if the failed link was MP-only, re-route around it.

    Returns a new Topology with the failed links removed, a replacement link
    rewired from the lowest-value MP link (if the failure broke a ring), and
    routing recomputed for affected pairs.
    """
    u, v = failed
    g = topo.graph.copy()
    broke_ring = False
    removed = {(u, v), (v, u)}
    for a, b in ((u, v), (v, u)):
        if g.has_edge(a, b):
            for key, data in list(g[a][b].items()):
                if data.get("kind") == "allreduce":
                    broke_ring = True
                g.remove_edge(a, b, key=key)

    if broke_ring:
        # Donate one MP link: rewire it to (u, v) to close the ring again.
        mp_edges = [
            (a, b, k)
            for a, b, k, data in g.edges(keys=True, data=True)
            if data.get("kind") == "mp" and (a, b) != (u, v) and (a, b) != (v, u)
        ]
        if mp_edges:
            a, b, k = mp_edges[0]
            g.remove_edge(a, b, key=k)
            if not g.has_edge(a, b):  # no parallel link left on that pair
                removed.add((a, b))
            g.add_edge(u, v, kind="allreduce", stride=None, repaired=True)
            removed.discard((u, v))

    repaired = Topology(
        n=topo.n, degree=topo.degree, graph=g, rings=topo.rings,
        d_allreduce=topo.d_allreduce, d_mp=topo.d_mp,
    )
    # Recompute routing on the surviving graph (shortest paths for every pair
    # previously routed through a removed link — the failure AND the donated
    # MP link).
    repaired.routing = _reroute_around(topo, g, removed)
    return repaired


def _reroute_around(topo: Topology, g: nx.MultiDiGraph,
                    removed: set) -> RoutingTable:
    """Keep routes that avoid ``removed`` links; re-path the rest by
    shortest path on ``g`` (drop pairs that became unreachable)."""
    simple = nx.DiGraph(g)
    new_routing = RoutingTable()
    for pair, rs in topo.routing.routes.items():
        keep = [
            r for r in rs
            if not any(hop in removed for hop in zip(r.path[:-1], r.path[1:]))
        ]
        if keep:
            new_routing.routes[pair] = keep
            continue
        try:
            path = nx.shortest_path(simple, pair[0], pair[1])
            new_routing.add(pair[0], pair[1], tuple(path))
        except (nx.NetworkXNoPath, nx.NodeNotFound):
            continue
    return new_routing


def remove_pair(topo: Topology, pair: tuple[int, int]) -> Topology:
    """Degrade a topology by a dead node pair (no §7 donation).

    Unlike :func:`repair_topology` — which models a cut *fiber* that a
    patch panel can re-create from a donated MP link — this models the pair
    itself becoming unusable (port/transceiver loss): both directions
    disappear, no replacement link may touch the pair, and routes that
    crossed it are re-pathed over the survivors.  This is the incumbent a
    static operator keeps running in :mod:`repro.core.online`, and the same
    constraint re-optimization passes to ``topology_finder(forbidden=...)``.
    """
    u, v = pair
    g = topo.graph.copy()
    removed = {(u, v), (v, u)}
    for a, b in ((u, v), (v, u)):
        if g.has_edge(a, b):
            for key in list(g[a][b]):
                g.remove_edge(a, b, key=key)
    degraded = Topology(
        n=topo.n, degree=topo.degree, graph=g, rings=topo.rings,
        d_allreduce=topo.d_allreduce, d_mp=topo.d_mp,
    )
    degraded.routing = _reroute_around(topo, g, removed)
    return degraded


def restore_pair(
    topo: Topology,
    pair: tuple[int, int],
    edges: list[tuple[int, int, dict]],
) -> Topology:
    """Invert :func:`remove_pair` after a transient fault heals.

    ``edges`` is the (a, b, edge-data) list snapshotted before the pair was
    removed; they are re-added verbatim and the restored directions get
    their direct route back.  Routes that were detoured around the dead
    pair keep their detour — they are valid, just suboptimal, and the next
    re-optimization (or :func:`_reroute_around`) tightens them.
    """
    g = topo.graph.copy()
    for a, b, data in edges:
        g.add_edge(a, b, **data)
    restored = Topology(
        n=topo.n, degree=topo.degree, graph=g, rings=topo.rings,
        d_allreduce=topo.d_allreduce, d_mp=topo.d_mp,
    )
    routing = RoutingTable(routes=dict(topo.routing.routes))
    for direction in {(a, b) for a, b, _ in edges}:
        routing.routes.pop(direction, None)
        routing.add(direction[0], direction[1], direction)
    restored.routing = routing
    return restored
