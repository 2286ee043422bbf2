"""Traffic demand extraction (paper §2, §4.1 inputs).

A parallelization strategy + device placement induces two demand kinds:

* ``AllReduceGroup`` — type (2) dependencies: weight sync among the nodes
  replicating the same part of the model.  *Mutable*: any ring permutation of
  the group carries it equally well.
* ``T_MP`` — type (1) dependencies: activations/gradients between nodes
  holding different parts of the model (TP collectives, EP all-to-all, DLRM
  embedding broadcast/incast, PP stage edges).  *Immutable* node pairs.

Units: bytes per training iteration.

Multi-tenant clusters (§6 shared-cluster deployment) aggregate several
jobs' demands on one fabric: :func:`remap_demand` embeds a job-local demand
into cluster index space under a placement, and :func:`union_demand` sums
the embedded demands into one cluster-level :class:`TrafficDemand` (the
union the shared TopologyFinder packs).  The :class:`repro_torch.core.workloads.JobSet`
abstraction drives both.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np


def sparse_min_nodes() -> int:
    """Node-count threshold for the sparse (COO) demand paths.

    ``REPRO_SPARSE_MIN_NODES`` (default 0: always sparse).  The sparse
    paths are bit-identical to the dense ones — this knob exists so fleet
    runs and ``benchmarks/bench_fleet.py`` can pin either path (e.g. a
    huge value forces the dense baseline) without code edits.
    """
    return int(os.environ.get("REPRO_SPARSE_MIN_NODES", "0"))


@dataclass(frozen=True)
class AllReduceGroup:
    """One AllReduce over ``members`` moving ``nbytes`` per member per
    iteration (ring AllReduce moves ~2 * nbytes per link around the ring)."""

    members: tuple[int, ...]
    nbytes: float

    @property
    def total(self) -> float:
        return self.nbytes * len(self.members)


@dataclass
class TrafficDemand:
    """Full per-iteration demand of a job on ``n`` nodes."""

    n: int
    allreduce: list[AllReduceGroup] = field(default_factory=list)
    mp: np.ndarray | None = None  # (n, n) bytes, mp[i, j] = i -> j
    # Serial latency rounds pinned by compiled collective schedules
    # (repro_torch.core.schedules); uncompiled ring groups contribute their
    # 2 (k-1) rounds through demand_steps() instead.
    steps: float = 0.0

    def __post_init__(self):
        if self.mp is None:
            self.mp = np.zeros((self.n, self.n), dtype=np.float64)
        self.mp = np.asarray(self.mp, dtype=np.float64)
        assert self.mp.shape == (self.n, self.n)
        self.steps = float(self.steps)

    @property
    def sum_allreduce(self) -> float:
        return float(sum(g.total for g in self.allreduce))

    @property
    def sum_mp(self) -> float:
        return float(self.mp.sum())

    def mp_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(srcs, dsts, vals)`` of the nonzero MP entries in
        ``np.nonzero`` (row-major) order, cached on the demand.

        This is the sparse handle the fleet-scale pricing paths key on: a
        compiled evaluator prices a cached demand in O(active pairs)
        instead of re-scanning the (n, n) matrix.  The first call
        **freezes** ``mp`` against further in-place writes (demands are
        built first, priced after — a later write raises loudly instead of
        silently diverging from the cache); replacing the ``mp`` attribute
        wholesale invalidates the cache instead.
        """
        cached = getattr(self, "_coo", None)
        if cached is not None and cached[0] is self.mp:
            return cached[1]
        srcs, dsts = np.nonzero(self.mp)
        coo = (srcs, dsts, self.mp[srcs, dsts])
        self.mp.flags.writeable = False
        self._coo = (self.mp, coo)
        return coo

    def set_mp_coo(
        self, srcs: np.ndarray, dsts: np.ndarray, vals: np.ndarray
    ) -> None:
        """Attach a precomputed COO (caller's contract: unique pairs in
        row-major order whose values equal ``mp``'s bit-for-bit — e.g.
        built by :func:`remap_demand` / :func:`union_embedded` from parts
        whose COOs are known).  Freezes ``mp`` like :meth:`mp_coo`."""
        self.mp.flags.writeable = False
        self._coo = (self.mp, (srcs, dsts, vals))

    def add_mp(self, src: int, dst: int, nbytes: float) -> None:
        if src != dst:
            self.mp[src, dst] += nbytes

    def add_all_to_all(self, members: Sequence[int], nbytes_per_pair: float) -> None:
        members = list(members)
        if len(set(members)) != len(members):
            # Repeated members accumulate per occurrence; keep loop semantics.
            for i in members:
                for j in members:
                    if i != j:
                        self.mp[i, j] += nbytes_per_pair
            return
        idx = np.asarray(members, dtype=np.int64)
        if idx.size <= 1:
            return
        # One addition per off-diagonal cell — same arithmetic as the loop.
        block = self.mp[np.ix_(idx, idx)]
        diag = block.diagonal().copy()
        block += nbytes_per_pair
        np.fill_diagonal(block, diag)
        self.mp[np.ix_(idx, idx)] = block

    def add_broadcast(self, src: int, dsts: Iterable[int], nbytes: float) -> None:
        """One-to-many MP pattern (e.g. DLRM embedding activations out)."""
        targets = [j for j in dsts if j != src]
        if len(set(targets)) == len(targets):
            self.mp[src, targets] += nbytes  # one add per cell, as the loop
        else:
            for j in targets:
                self.mp[src, j] += nbytes

    def add_incast(self, srcs: Iterable[int], dst: int, nbytes: float) -> None:
        """Many-to-one MP pattern (e.g. DLRM embedding gradients back)."""
        sources = [i for i in srcs if i != dst]
        if len(set(sources)) == len(sources):
            self.mp[sources, dst] += nbytes
        else:
            for i in sources:
                self.mp[i, dst] += nbytes


# ---------------------------------------------------------------------------
# Multi-tenant aggregation: placement remap + union demand
# ---------------------------------------------------------------------------


def remap_demand(
    demand: TrafficDemand, servers: Sequence[int], n_cluster: int
) -> TrafficDemand:
    """Embed a job-local demand into cluster index space.

    ``servers[i]`` is the cluster node hosting the job's local node ``i``;
    AllReduce group members are relabelled and the MP matrix lands on the
    ``servers x servers`` block.  Mutability is preserved: the relabelled
    groups stay ring-permutable, the relabelled MP pairs stay pinned.
    """
    servers = tuple(int(s) for s in servers)
    if len(servers) != demand.n:
        raise ValueError(
            f"placement has {len(servers)} servers for a demand on {demand.n}"
        )
    if len(set(servers)) != len(servers):
        raise ValueError(f"placement {servers!r} repeats a server")
    if servers and not (0 <= min(servers) and max(servers) < n_cluster):
        raise ValueError(f"placement {servers!r} outside cluster of {n_cluster}")
    out = TrafficDemand(n=n_cluster, steps=demand.steps)
    for g in demand.allreduce:
        out.allreduce.append(
            AllReduceGroup(
                members=tuple(servers[m] for m in g.members), nbytes=g.nbytes
            )
        )
    if servers:
        idx = np.asarray(servers, dtype=np.int64)
        out.mp[np.ix_(idx, idx)] += demand.mp
        if n_cluster >= sparse_min_nodes():
            # The embedded matrix's nonzeros are exactly the job-local
            # nonzeros moved to (servers[s], servers[d]) — attach the COO
            # now (O(k^2) local scan) so pricing the cluster-level demand
            # never re-scans the (n, n) matrix.
            ls, ld, v = demand.mp_coo()
            gs, gd = idx[ls], idx[ld]
            order = np.lexsort((gd, gs))  # row-major global order
            out.set_mp_coo(gs[order], gd[order], v[order])
    return out


def rebase_demand(
    demand: TrafficDemand,
    old_servers: Sequence[int],
    new_servers: Sequence[int],
) -> TrafficDemand:
    """Relabel a *cluster-level* demand from one placement to another.

    ``old_servers[i]`` -> ``new_servers[i]``: AllReduce members are mapped
    through the placement bijection and the MP block moves from the old
    server set to the new one.  This is the candidate-placement /
    migration fast path: a tenant's embedded demand can be re-seated
    without rebuilding the whole union —
    ``rebase_demand(remap_demand(d, old, n), old, new)`` equals
    ``remap_demand(d, new, n)`` entry for entry.
    """
    old_servers = tuple(int(s) for s in old_servers)
    new_servers = tuple(int(s) for s in new_servers)
    if len(old_servers) != len(new_servers):
        raise ValueError(
            f"placement sizes differ: {len(old_servers)} vs {len(new_servers)}"
        )
    if len(set(new_servers)) != len(new_servers):
        raise ValueError(f"placement {new_servers!r} repeats a server")
    n = demand.n
    if new_servers and not (0 <= min(new_servers) and max(new_servers) < n):
        raise ValueError(f"placement {new_servers!r} outside cluster of {n}")
    mapping = dict(zip(old_servers, new_servers))
    out = TrafficDemand(n=n, steps=demand.steps)
    for g in demand.allreduce:
        out.allreduce.append(
            AllReduceGroup(
                members=tuple(mapping.get(m, m) for m in g.members),
                nbytes=g.nbytes,
            )
        )
    if old_servers:
        old_idx = np.asarray(old_servers, dtype=np.int64)
        new_idx = np.asarray(new_servers, dtype=np.int64)
        block = demand.mp[np.ix_(old_idx, old_idx)].copy()
        out.mp[:] = demand.mp
        out.mp[np.ix_(old_idx, old_idx)] = 0.0
        out.mp[np.ix_(new_idx, new_idx)] += block
    else:
        out.mp[:] = demand.mp
    return out


def union_demand(
    parts: Iterable[TrafficDemand], n: int | None = None
) -> TrafficDemand:
    """Sum cluster-level demands into one (MP matrices add; AllReduce groups
    concatenate, merging groups with identical member tuples).

    The union preserves totals exactly: ``sum_mp`` and ``sum_allreduce`` of
    the result equal the sums over ``parts`` — the invariant
    ``tests/test_multitenant.py`` pins.
    """
    parts = list(parts)
    if n is None:
        if not parts:
            raise ValueError("union_demand needs parts or an explicit n")
        n = parts[0].n
    out = TrafficDemand(n=n)
    sparse = n >= sparse_min_nodes()
    touched: list[np.ndarray] = []
    merged: dict[tuple[int, ...], float] = {}
    order: list[tuple[int, ...]] = []
    for p in parts:
        if p.n != n:
            raise ValueError(f"demand on {p.n} nodes in a union over {n}")
        if sparse:
            # Scatter only the part's nonzeros: each touched cell receives
            # the same addition, in the same part order, as the dense
            # ``out.mp += p.mp`` — and adding 0.0 to a nonnegative float is
            # a bitwise no-op, so skipping the zero cells is exact.
            ps, pd, pv = p.mp_coo()
            if ps.size:
                out.mp[ps, pd] += pv
                touched.append(ps.astype(np.int64) * n + pd)
        else:
            out.mp += p.mp
        out.steps = max(out.steps, p.steps)
        for g in p.allreduce:
            if g.members not in merged:
                order.append(g.members)
                merged[g.members] = 0.0
            merged[g.members] += g.nbytes
    out.allreduce = [
        AllReduceGroup(members=m, nbytes=merged[m]) for m in order
    ]
    if sparse:
        keys = (
            np.unique(np.concatenate(touched))
            if touched
            else np.zeros(0, dtype=np.int64)
        )
        srcs, dsts = keys // n, keys % n
        out.set_mp_coo(srcs, dsts, out.mp[srcs, dsts])
    return out


def union_embedded(
    parts: Iterable[tuple[TrafficDemand, Sequence[int]]], n: int
) -> TrafficDemand:
    """Union of job-local demands embedded under their placements.

    Bit-identical to ``union_demand([remap_demand(d, s, n) for d, s in
    parts], n)`` without materializing any per-tenant (n, n) matrix: each
    part contributes its COO entries straight into the one union matrix —
    O(active pairs) per tenant instead of O(n^2) — which is what lets
    fleet-sized jobsets re-union on every arrival/departure/move.  The
    per-cell additions are the dense path's exactly (same values, same
    part order; the dense path's additions of 0.0 elsewhere are bitwise
    no-ops on the nonnegative byte matrices).
    """
    out = TrafficDemand(n=n)
    touched: list[np.ndarray] = []
    merged: dict[tuple[int, ...], float] = {}
    order: list[tuple[int, ...]] = []
    for demand, servers in parts:
        servers = tuple(int(s) for s in servers)
        # Same placement validation as remap_demand.
        if len(servers) != demand.n:
            raise ValueError(
                f"placement has {len(servers)} servers for a demand on "
                f"{demand.n}"
            )
        if len(set(servers)) != len(servers):
            raise ValueError(f"placement {servers!r} repeats a server")
        if servers and not (0 <= min(servers) and max(servers) < n):
            raise ValueError(f"placement {servers!r} outside cluster of {n}")
        out.steps = max(out.steps, demand.steps)
        for g in demand.allreduce:
            members = tuple(servers[m] for m in g.members)
            if members not in merged:
                order.append(members)
                merged[members] = 0.0
            merged[members] += g.nbytes
        if servers:
            idx = np.asarray(servers, dtype=np.int64)
            ls, ld, v = demand.mp_coo()
            if ls.size:
                gs, gd = idx[ls], idx[ld]
                out.mp[gs, gd] += v
                touched.append(gs * n + gd)
    out.allreduce = [
        AllReduceGroup(members=m, nbytes=merged[m]) for m in order
    ]
    keys = (
        np.unique(np.concatenate(touched))
        if touched
        else np.zeros(0, dtype=np.int64)
    )
    srcs, dsts = keys // n, keys % n
    out.set_mp_coo(srcs, dsts, out.mp[srcs, dsts])
    return out


def demand_steps(demand: TrafficDemand) -> float:
    """Serial latency rounds of a demand — the α multiplier of the (α, β)
    cost model: the compiled-schedule ``demand.steps`` floor, raised to each
    active (nbytes > 0, k > 1) uncompiled ring group's ``2 (k-1)`` rounds.
    Topology-independent, so evaluators can memoize it per demand."""
    steps = demand.steps
    for g in demand.allreduce:
        k = len(g.members)
        if g.nbytes > 0.0 and k > 1:
            steps = max(steps, 2.0 * (k - 1))
    return steps


# ---------------------------------------------------------------------------
# Demand builders for the model families used in the paper + assigned archs.
# ---------------------------------------------------------------------------


def data_parallel_demand(n: int, param_bytes: float) -> TrafficDemand:
    """Pure DP: one global AllReduce of the full gradient per iteration."""
    d = TrafficDemand(n=n)
    d.allreduce.append(AllReduceGroup(members=tuple(range(n)), nbytes=param_bytes))
    return d


def hybrid_demand(
    n: int,
    dp_param_bytes: float,
    mp_pairs: Iterable[tuple[int, int, float]] = (),
    subgroup_allreduce: Iterable[tuple[Sequence[int], float]] = (),
) -> TrafficDemand:
    """Hybrid data+model parallel demand: a global (or per-subgroup)
    AllReduce for replicated parts plus explicit MP transfers."""
    d = TrafficDemand(n=n)
    if dp_param_bytes > 0:
        d.allreduce.append(AllReduceGroup(members=tuple(range(n)), nbytes=dp_param_bytes))
    for members, nbytes in subgroup_allreduce:
        d.allreduce.append(AllReduceGroup(members=tuple(members), nbytes=nbytes))
    for src, dst, nbytes in mp_pairs:
        d.add_mp(src, dst, nbytes)
    return d


def dlrm_demand(
    n: int,
    dense_param_bytes: float,
    table_hosts: Sequence[int],
    activation_bytes_per_host: float,
) -> TrafficDemand:
    """DLRM (§2.1): dense part replicated (AllReduce), embedding tables on
    ``table_hosts`` with one-to-many broadcast of looked-up rows and
    many-to-one incast of their gradients."""
    d = data_parallel_demand(n, dense_param_bytes)
    hosts = list(table_hosts)
    if len(set(hosts)) == len(hosts):
        # Vectorized build (the strategy-search hot path): every touched
        # cell starts at zero, so one row add + one column add + a diagonal
        # reset reproduces the per-host loop's values exactly.
        idx = np.asarray(hosts, dtype=np.int64)
        if idx.size:
            d.mp[idx, :] += activation_bytes_per_host
            d.mp[:, idx] += activation_bytes_per_host
            d.mp[idx, idx] = 0.0
        return d
    everyone = range(n)
    for h in hosts:
        d.add_broadcast(h, everyone, activation_bytes_per_host)
        d.add_incast(everyone, h, activation_bytes_per_host)
    return d


def moe_demand(
    n: int,
    dp_param_bytes: float,
    ep_groups: Iterable[Sequence[int]],
    a2a_bytes_per_pair: float,
    expert_param_bytes: float = 0.0,
) -> TrafficDemand:
    """MoE: dense grads AllReduce over everyone; expert grads AllReduce within
    each expert-replication group; token dispatch/combine all-to-all within
    each EP group (twice per layer pass, folded into a2a_bytes_per_pair)."""
    d = data_parallel_demand(n, dp_param_bytes)
    for g in ep_groups:
        d.add_all_to_all(g, a2a_bytes_per_pair)
        if expert_param_bytes > 0:
            d.allreduce.append(AllReduceGroup(members=tuple(g), nbytes=expert_param_bytes))
    return d
