"""Collective schedules as demand compilers (ROADMAP item 2).

TopoOpt's fluid model prices every AllReduce as a *ring* schedule:
``2 (k-1)/k * M`` per ring link over ``2 (k-1)`` latency rounds.  That is
bandwidth-optimal but latency-pessimal — small-message groups and MoE
expert AllReduces pay ``O(k)`` rounds when ``O(log k)`` schedules exist at
equal wire bytes (Zhao et al., "Efficient Direct-Connect Topologies for
Collective Communications", arXiv 2202.03356).

A :class:`CollectiveSchedule` compiles an :class:`~repro_torch.core.demand.AllReduceGroup`
into

* **pair loads** — pinned (src, dst, bytes) MP demand entries the
  TopologyFinder can Blossom-match direct links onto, and
* a **step count** — the schedule's serial round count, priced by the
  ``(α, β)`` cost model as ``hw.link_latency * steps`` on top of the fluid
  bandwidth bottleneck (β term).

Every schedule conserves total wire bytes: an AllReduce of ``M`` bytes over
``k`` members moves exactly ``2 (k-1) M`` bytes regardless of schedule —
the invariant ``tests/test_schedule_properties.py`` pins.

``"ring"`` compiles to the identity (the group stays mutable AllReduce
demand), so the default is byte-identical to the pre-schedule code path.
"""

from __future__ import annotations

from .demand import AllReduceGroup, TrafficDemand
from .select_perms import schedule_strides
from .totient import ring_order

SCHEDULES = ("ring", "recursive_hd", "multi_tree")

PairLoads = dict[tuple[int, int], float]


def _pow2_floor(k: int) -> int:
    """Largest power of two <= k (k >= 1)."""
    return 1 << (k.bit_length() - 1)


class CollectiveSchedule:
    """One AllReduce schedule: a demand compiler plus an (α, β) cost shape.

    ``pair_loads(members, nbytes)`` returns the pinned per-pair wire bytes;
    ``steps(k)`` the serial latency rounds (the α multiplier).  ``ring``
    overrides neither — it stays uncompiled ring-AllReduce demand.
    """

    name: str = "?"

    def pair_loads(self, members: tuple[int, ...], nbytes: float) -> PairLoads:
        raise NotImplementedError

    def steps(self, k: int) -> float:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}()"


class RingSchedule(CollectiveSchedule):
    """Ring AllReduce — the identity compile: the group stays a mutable
    :class:`AllReduceGroup` (any ring permutation serves it), costing
    ``2 (k-1)/k * M`` per ring link over ``2 (k-1)`` rounds."""

    name = "ring"

    def pair_loads(self, members: tuple[int, ...], nbytes: float) -> PairLoads:
        raise TypeError("ring schedule is not compiled to pinned pairs")

    def steps(self, k: int) -> float:
        return 2.0 * (k - 1) if k > 1 else 0.0


class RecursiveHDSchedule(CollectiveSchedule):
    """Recursive halving-doubling: reduce-scatter by recursive halving over
    power-of-two exchange distances, then allgather by recursive doubling.

    The ``p2 = 2^L <= k`` core runs ``2 L`` rounds; a non-power-of-two group
    folds the ``k - p2`` extras in (full-vector pre/post exchange, +2
    rounds).  Round ``r`` pairs core rank ``i`` with ``i XOR 2^r`` carrying
    ``M / 2^r`` combined (RS ``M/2^(r+1)`` + AG ``M/2^(r+1)``) — total wire
    bytes ``2 (p2-1) M + 2 (k-p2) M = 2 (k-1) M``, same as ring.
    """

    name = "recursive_hd"

    def pair_loads(self, members: tuple[int, ...], nbytes: float) -> PairLoads:
        k = len(members)
        validate_hd_group(k)
        p2 = _pow2_floor(k)
        loads: PairLoads = {}

        def add(a: int, b: int, x: float) -> None:
            loads[(a, b)] = loads.get((a, b), 0.0) + x

        # Fold: extras hand their full vector to a core partner and get the
        # finished result back.
        for j in range(k - p2):
            extra, partner = members[p2 + j], members[j]
            add(extra, partner, nbytes)
            add(partner, extra, nbytes)
        # Halving-doubling core over the first p2 members.
        for r, dist in enumerate(schedule_strides(p2, "recursive_hd")):
            share = nbytes / float(1 << r)
            for i in range(p2):
                add(members[i], members[i ^ dist], share)
        return loads

    def steps(self, k: int) -> float:
        if k < 2:
            return 0.0
        p2 = _pow2_floor(k)
        return 2.0 * (p2.bit_length() - 1) + (2.0 if k > p2 else 0.0)


class MultiTreeSchedule(CollectiveSchedule):
    """Multi-tree AllReduce: the vector splits across ``n_trees`` balanced
    binary reduce+broadcast trees, each rooted on a different TotientPerms
    ring order (Algorithm 3 selects the seeding strides) so tree edges
    spread over distinct node pairs.

    Each tree carries ``M / n_trees`` up its ``k-1`` edges and back down —
    total wire bytes ``2 (k-1) M``, same as ring, in ``2 floor(log2 k)``
    rounds.
    """

    name = "multi_tree"
    n_trees = 2

    def pair_loads(self, members: tuple[int, ...], nbytes: float) -> PairLoads:
        k = len(members)
        strides = schedule_strides(k, "multi_tree", self.n_trees)
        if not strides:
            raise ValueError(f"multi_tree needs a group of >= 2, got {k}")
        share = nbytes / float(len(strides))
        loads: PairLoads = {}

        def add(a: int, b: int, x: float) -> None:
            loads[(a, b)] = loads.get((a, b), 0.0) + x

        for p in strides:
            order = [members[i] for i in ring_order(k, p)]
            for i in range(1, k):
                parent, child = order[(i - 1) // 2], order[i]
                add(child, parent, share)  # reduce up
                add(parent, child, share)  # broadcast down
        return loads

    def steps(self, k: int) -> float:
        return 2.0 * (k.bit_length() - 1) if k > 1 else 0.0


def validate_hd_group(k: int) -> int:
    """Halving-doubling group-size check: needs >= 2 ranks; returns the
    power-of-two core size ``p2`` (non-power-of-two sizes fold, they do not
    fail).  Raises ``ValueError`` on degenerate groups — the negative-test
    hook for n=1 groups."""
    if k < 2:
        raise ValueError(
            f"recursive halving-doubling needs a group of >= 2, got {k}"
        )
    return _pow2_floor(k)


_REGISTRY: dict[str, CollectiveSchedule] = {
    s.name: s for s in (RingSchedule(), RecursiveHDSchedule(), MultiTreeSchedule())
}


def get_schedule(name: str) -> CollectiveSchedule:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown collective schedule {name!r}: expected one of {SCHEDULES}"
        ) from None


def apply_schedule(demand: TrafficDemand, schedule: str = "ring") -> TrafficDemand:
    """Compile a demand's AllReduce groups under one schedule.

    ``"ring"`` returns ``demand`` unchanged (same object — the byte-identical
    default).  Other schedules pin each active group's traffic as MP pair
    loads, keep a zero-byte group in place (the TopologyFinder still
    reserves its connectivity ring), and raise ``demand.steps`` to the
    schedule's round count.  Zero-byte or singleton groups pass through.
    """
    sched = get_schedule(schedule)
    if sched.name == "ring":
        return demand
    out = TrafficDemand(n=demand.n, mp=demand.mp.copy(), steps=demand.steps)
    groups: list[AllReduceGroup] = []
    for g in demand.allreduce:
        k = len(g.members)
        if g.nbytes <= 0.0 or k < 2:
            groups.append(g)
            continue
        for (a, b), x in sched.pair_loads(g.members, g.nbytes).items():
            out.mp[a, b] += x
        groups.append(AllReduceGroup(members=g.members, nbytes=0.0))
        out.steps = max(out.steps, float(sched.steps(k)))
    out.allreduce = groups
    return out
