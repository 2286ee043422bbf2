"""Compiled plan evaluator — the alternating-optimization hot loop (§4.1).

:func:`repro_torch.core.netsim.topoopt_comm_time` is the *reference* fluid
objective: per candidate it walks every AllReduce ring edge and every routed
MP hop through Python dicts.  The alternating loop evaluates hundreds of
(strategy, topology) candidates per replan, and the online layer
(:mod:`repro.core.online`) re-enters it on every failure/arrival — so the
reference path's per-candidate constant dominates end-to-end replan latency.

This module compiles a fixed :class:`~repro_torch.core.topology_finder.Topology`
into flat NumPy structure arrays **once** and prices candidate demands
against them in microseconds:

* a growable *link-id table* — every directed node pair that can carry load
  (physical graph edges, planned ring edges, routed hops) gets a dense id,
  with per-link capacity ``parallel_links * link_bandwidth`` so the final
  bottleneck max is one vectorized ``max(loads / cap)``;
* per-AllReduce-group *ring-edge incidence* — the link ids of a group's
  ring edges in exact reference walk order, so a group's load is one
  ``np.add.at`` scatter instead of nested ring/edge loops;
* a persistent *MP route cache* in CSR form — per source/dest pair the link
  ids of its (fallback-completed) route hops, so a whole MP matrix prices
  as one segment-gather + ``np.add.at``.

**Bit-exactness.**  The full evaluation (:meth:`PlanEvaluator.loads` /
:meth:`comm_time`) reproduces the reference *to the bit*, not merely to
1e-9: shares are computed with the same expressions (``2(k-1)/k * bytes``
then ``/ n_rings``; ``bytes / n_routes`` per route), scattered per
*occurrence* in the same order the reference walks them (``np.add.at`` is
documented unbuffered-sequential), AllReduce and MP accumulate in separate
vectors merged with one elementwise add (mirroring the reference's two-dict
merge), and the bottleneck uses the same ``load / (par * bandwidth)``
division.  This matters because MCMC acceptance uses ``<=``: a move that
leaves the objective mathematically unchanged must *tie exactly*, or
fixed-seed chains diverge from the pre-compiled behaviour.

On top of the per-demand path, :class:`JobSetEvaluator` makes the
multi-tenant MCMC **incremental**: per-tenant cluster-level link-load
vectors are cached, and a single-tenant move re-prices only
``total - old_vector + new_vector`` instead of re-unioning and re-walking
the whole JobSet.  :meth:`PlanEvaluator.loads_delta` is the single-job
analogue (diff the moved demand's groups/MP entries against the incumbent
load vector).  Incremental results carry ulp-level arithmetic lineage, so
the search loops confirm near-boundary acceptance decisions on the
bit-exact full evaluation (see ``_TIE_RTOL`` in
:mod:`repro_torch.core.strategy_search`).

``tests/test_planeval.py`` pins compiled-vs-reference agreement over random
topologies, demands, jobsets, and degraded fabrics.  Degradation helpers
(:func:`~repro_torch.core.topology_finder.remove_pair` /
:func:`~repro_torch.core.topology_finder.repair_topology`) return *new* Topology
objects, so their evaluators recompile from scratch — a stale cache cannot
survive a fabric change.
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict

import numpy as np

from .demand import TrafficDemand, demand_steps, remap_demand, sparse_min_nodes

logger = logging.getLogger(__name__)
from .netsim import (
    HardwareSpec,
    _iteration_time as iteration_time,
    _routing_with_fallback,
    compute_time,
)

__all__ = [
    "LRUCache",
    "PlanEvaluator",
    "JobSetEvaluator",
    "plan_evaluator",
]


class LRUCache:
    """Minimal least-recently-used mapping (bounds the long-MCMC caches).

    ``get``/``__getitem__`` refresh recency; inserting past ``maxsize``
    evicts the least recently used entry.  Drop-in for the plain dicts the
    search loops used to grow without limit.

    Tracks lookup hit/miss counts (``hits`` / ``misses`` /
    :attr:`hit_rate`) so fleet runs can tune cache sizes
    (``REPRO_DEMAND_CACHE_SIZE`` / ``REPRO_VECTOR_CACHE_SIZE``) from
    logged rates instead of code edits.
    """

    def __init__(self, maxsize: int = 512):
        if maxsize < 1:
            raise ValueError("LRUCache needs maxsize >= 1")
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._data: OrderedDict = OrderedDict()

    def __contains__(self, key) -> bool:
        found = key in self._data
        if found:
            self.hits += 1
        else:
            self.misses += 1
        return found

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups served from cache (0.0 when never probed)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict[str, float]:
        return {
            "size": len(self._data),
            "maxsize": self.maxsize,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
        }

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, key):
        value = self._data[key]
        self._data.move_to_end(key)
        return value

    def __setitem__(self, key, value) -> None:
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        if len(self._data) > self.maxsize:
            self._data.popitem(last=False)

    def get(self, key, default=None):
        if key in self._data:
            self.hits += 1
            return self[key]
        self.misses += 1
        return default

    def clear(self) -> None:
        self._data.clear()


class PlanEvaluator:
    """A :class:`Topology` compiled to flat arrays for microsecond pricing.

    Build once per topology (use :func:`plan_evaluator`, which memoizes the
    instance on the topology object) and call :meth:`comm` /
    :meth:`comm_time` with any demand on the same node count.  Group
    incidence and MP routes compile lazily on first touch and persist
    across evaluations — the route cache the reference path rebuilt per
    call.
    """

    def __init__(self, topo, hw: HardwareSpec, sparse_min_nodes_: int | None = None):
        self.topo = topo
        self.hw = hw
        self._n = topo.n
        # Sparse pricing: key MP entries off each demand's cached COO
        # (TrafficDemand.mp_coo) instead of re-scanning the (n, n) matrix,
        # and bottleneck only the touched links.  Bit-identical to the
        # dense path; threshold from REPRO_SPARSE_MIN_NODES (kwarg wins).
        if sparse_min_nodes_ is None:
            sparse_min_nodes_ = sparse_min_nodes()
        self._sparse = self._n >= sparse_min_nodes_
        # Parallel-link counts of the physical graph (multi-edges counted),
        # exactly the reference's ``n_par``.
        par: dict[tuple[int, int], int] = {}
        for edge in topo.graph.edges():
            par[edge] = par.get(edge, 0) + 1
        self._par = par
        # Growable link-id table: directed pair -> dense id; cap[lid] =
        # max(1, parallel_links) * link_bandwidth (the reference divisor).
        self._lid: dict[tuple[int, int], int] = {}
        self._cap = np.zeros(64, dtype=np.float64)
        self._n_links = 0
        for pair in par:
            self._link_id(pair)
        # AllReduce group incidence: members -> (occurrence link ids in
        # ring-then-edge order, n_rings, k), or None when the group carries
        # no rings on this topology (the reference skips it too).
        self._groups: dict[tuple[int, ...], tuple | None] = {}
        # MP pair route cache, CSR over pair id p = s*n + t: per-occurrence
        # hop link ids in route-then-hop order (the reference walk order),
        # the pair's route count (share divisor), and its mean route hops
        # (bandwidth-tax factor; 1.0 for unroutable ~ direct).
        n2 = self._n * self._n
        self._pair_start = np.full(n2, -1, dtype=np.int64)
        self._pair_len = np.zeros(n2, dtype=np.int64)
        self._pair_nroutes = np.ones(n2, dtype=np.float64)
        self._pair_tax = np.zeros(n2, dtype=np.float64)
        self._mp_ids = np.zeros(256, dtype=np.int64)
        self._mp_size = 0

    # -- link universe -------------------------------------------------------

    @property
    def n_links(self) -> int:
        """Current size of the compiled link universe (grows lazily)."""
        return self._n_links

    @property
    def caps(self) -> np.ndarray:
        """Per-link capacities over the current universe (read-only view:
        ``parallel_links * link_bandwidth`` per compiled directed pair)."""
        return self._cap[: self._n_links]

    def _link_id(self, pair: tuple[int, int]) -> int:
        lid = self._lid.get(pair)
        if lid is None:
            lid = self._n_links
            self._lid[pair] = lid
            if lid >= self._cap.size:
                grown = np.zeros(2 * self._cap.size, dtype=np.float64)
                grown[: self._cap.size] = self._cap
                self._cap = grown
            par = max(1, self._par.get(pair, 1))
            self._cap[lid] = par * self.hw.link_bandwidth
            self._n_links += 1
        return lid

    def pad(self, loads: np.ndarray) -> np.ndarray:
        """Zero-extend a load vector minted before the universe grew."""
        if loads.size == self._n_links:
            return loads
        out = np.zeros(self._n_links, dtype=np.float64)
        out[: loads.size] = loads
        return out

    # -- lazy compilation ----------------------------------------------------

    def _group(self, members: tuple[int, ...]):
        if members not in self._groups:
            rings = self.topo.rings.get(members, [])
            k = len(members)
            if not rings or k <= 1:
                self._groups[members] = None
            else:
                ids = np.fromiter(
                    (
                        self._link_id(edge)
                        for ring in rings
                        for edge in ring.edges()
                    ),
                    dtype=np.int64,
                )
                self._groups[members] = (ids, len(rings), k)
        return self._groups[members]

    def _compile_pair(self, s: int, t: int) -> None:
        routes = self.topo.routing.get(s, t)
        if not routes:
            routes = _routing_with_fallback(
                self.topo, [(s, t, 1.0)]
            ).get(s, t)
        pid = s * self._n + t
        self._pair_start[pid] = self._mp_size
        if not routes:
            # Unroutable ~ direct in the reference tax; no link load.
            self._pair_len[pid] = 0
            self._pair_tax[pid] = 1.0
            return
        ids = [
            self._link_id(hop)
            for r in routes
            for hop in zip(r.path[:-1], r.path[1:])
        ]
        need = self._mp_size + len(ids)
        if need > self._mp_ids.size:
            size = max(2 * self._mp_ids.size, need)
            grown = np.zeros(size, dtype=np.int64)
            grown[: self._mp_ids.size] = self._mp_ids
            self._mp_ids = grown
        self._mp_ids[self._mp_size: self._mp_size + len(ids)] = ids
        self._mp_size += len(ids)
        self._pair_len[pid] = len(ids)
        self._pair_nroutes[pid] = len(routes)
        self._pair_tax[pid] = sum(r.hops for r in routes) / len(routes)

    def _compile_missing(self, pids: np.ndarray) -> None:
        if pids.size:
            for pid in pids[self._pair_start[pids] < 0]:
                self._compile_pair(int(pid) // self._n, int(pid) % self._n)

    def _mp_arrays(self, mp: np.ndarray):
        """(pids, bytes) of a demand's nonzero MP entries, with every pair
        compiled into the CSR cache."""
        srcs, dsts = np.nonzero(mp)
        vals = mp[srcs, dsts]
        pids = srcs * self._n + dsts
        self._compile_missing(pids)
        return pids, vals

    def _ensure_compiled(self, demand: TrafficDemand):
        """Compile everything a demand touches (so the link universe stops
        growing before the load vector is allocated).

        On the sparse path the MP entries come from the demand's cached
        COO (same pairs, same row-major order, same float values as the
        ``np.nonzero`` scan — O(active pairs) on repeat pricings)."""
        for g in demand.allreduce:
            self._group(g.members)
        if self._sparse:
            srcs, dsts, vals = demand.mp_coo()
            pids = srcs.astype(np.int64) * self._n + dsts
            self._compile_missing(pids)
            return pids, vals
        return self._mp_arrays(demand.mp)

    # -- evaluation ----------------------------------------------------------

    def _scatter_mp(self, loads, pids, vals, sign: float = 1.0) -> None:
        """Add each pair's per-route share (``bytes / n_routes``) along its
        route hops — one sequential ``np.add.at`` in the reference's
        flow-then-route-then-hop order."""
        starts = self._pair_start[pids]
        lens = self._pair_len[pids]
        total = int(lens.sum())
        if not total:
            return
        seg_off = np.cumsum(lens) - lens
        idx = (
            np.arange(total, dtype=np.int64)
            - np.repeat(seg_off, lens)
            + np.repeat(starts, lens)
        )
        shares = (sign * vals) / self._pair_nroutes[pids]
        np.add.at(loads, self._mp_ids[idx], np.repeat(shares, lens))

    def _scatter_groups(self, loads, allreduce, sign: float = 1.0) -> None:
        """Add each group's per-ring-edge share in the reference's
        group-then-ring-then-edge order (duplicate edges accumulate
        sequentially, exactly like the reference dict walk)."""
        for g in allreduce:
            entry = self._group(g.members)
            if entry is None:
                continue
            ids, n_rings, k = entry
            per_link_total = 2.0 * (k - 1) / k * g.nbytes
            if per_link_total == 0.0:
                continue
            np.add.at(loads, ids, sign * (per_link_total / n_rings))

    def _eval(self, demand: TrafficDemand):
        """(loads, pids, vals) of one demand — the single scatter/merge
        body every evaluation entry point shares (the bit-exactness
        contract lives here and nowhere else)."""
        pids, vals = self._ensure_compiled(demand)
        ar = np.zeros(self._n_links, dtype=np.float64)
        self._scatter_groups(ar, demand.allreduce)
        mp = np.zeros(self._n_links, dtype=np.float64)
        self._scatter_mp(mp, pids, vals)
        # One elementwise add mirrors the reference's AllReduce-dict +
        # link_loads-dict merge (a single addition per link).
        ar += mp
        return ar, pids, vals

    def _eval_compact(self, demand: TrafficDemand):
        """(touched link ids, compact loads, pids, vals) of one demand —
        the same scatters as :meth:`_eval` into a vector over only the
        links the demand touches, so per-candidate pricing cost scales
        with active edges instead of the link-table size.

        Per-link sums are bit-identical to :meth:`_eval`: each compact
        slot receives exactly the additions its full-vector link receives,
        in the same sequential ``np.add.at`` order (groups in demand
        order, then the MP occurrence stream), and the AllReduce/MP
        vectors merge with the same single add."""
        pids, vals = self._ensure_compiled(demand)
        group_entries: list[tuple[np.ndarray, float]] = []
        occ_parts: list[np.ndarray] = []
        for g in demand.allreduce:
            entry = self._group(g.members)
            if entry is None:
                continue
            ids, n_rings, k = entry
            per_link_total = 2.0 * (k - 1) / k * g.nbytes
            if per_link_total == 0.0:
                continue
            group_entries.append((ids, per_link_total / n_rings))
            occ_parts.append(ids)
        starts = self._pair_start[pids]
        lens = self._pair_len[pids]
        total = int(lens.sum())
        if total:
            seg_off = np.cumsum(lens) - lens
            idx = (
                np.arange(total, dtype=np.int64)
                - np.repeat(seg_off, lens)
                + np.repeat(starts, lens)
            )
            occ_parts.append(self._mp_ids[idx])
        if not occ_parts:
            empty = np.zeros(0, dtype=np.int64)
            return empty, np.zeros(0, dtype=np.float64), pids, vals
        occ = np.concatenate(occ_parts)
        touched, inv = np.unique(occ, return_inverse=True)
        ar = np.zeros(touched.size, dtype=np.float64)
        off = 0
        for ids, share in group_entries:
            np.add.at(ar, inv[off: off + ids.size], share)
            off += ids.size
        mp = np.zeros(touched.size, dtype=np.float64)
        if total:
            shares = vals / self._pair_nroutes[pids]
            np.add.at(mp, inv[off:], np.repeat(shares, lens))
        ar += mp
        return touched, ar, pids, vals

    def _bottleneck_compact(self, touched: np.ndarray, loads: np.ndarray) -> float:
        """Bottleneck over the touched links only — equal to the full-max
        (untouched loads are zero and loads are nonnegative, so they can
        never win the max; an all-zero demand bottlenecks at 0.0 both
        ways)."""
        if not touched.size:
            return 0.0
        return float(np.max(loads / self._cap[touched]))

    def loads(self, demand: TrafficDemand) -> np.ndarray:
        """Per-link byte loads (AllReduce rings + routed MP) as a flat
        vector over the compiled link universe — bit-identical to the
        reference's per-link dict values."""
        return self._eval(demand)[0]

    def loads_delta(
        self,
        base: np.ndarray,
        old: TrafficDemand,
        new: TrafficDemand,
    ) -> np.ndarray:
        """Load vector of ``new`` given ``base = loads(old)``: re-prices
        only the delta between the two demands (changed AllReduce groups,
        changed MP entries) — the single-move fast path of
        :func:`~repro_torch.core.strategy_search.mcmc_search`.  Entries untouched
        by the move stay bit-identical to ``base``; touched entries carry
        ulp-level lineage (the search loop's near-boundary confirmation
        falls back to the bit-exact :meth:`loads`)."""
        same_groups = old.allreduce is new.allreduce or (
            len(old.allreduce) == len(new.allreduce)
            and all(
                a.members == b.members and a.nbytes == b.nbytes
                for a, b in zip(old.allreduce, new.allreduce)
            )
        )
        gone: list = []
        added: list = []
        if not same_groups:
            old_keys = [(g.members, g.nbytes) for g in old.allreduce]
            new_keys = [(g.members, g.nbytes) for g in new.allreduce]
            shared = set(old_keys) & set(new_keys)
            gone = [g for g, k in zip(old.allreduce, old_keys)
                    if k not in shared]
            added = [g for g, k in zip(new.allreduce, new_keys)
                     if k not in shared]
            for g in (*gone, *added):
                self._group(g.members)
        if self._sparse:
            # COO diff: for a pair in both demands the dense cell is
            # ``new - old`` (one float subtraction); the sequential
            # ``np.add.at`` below performs ``(0 + new) + (-old)`` — the
            # identical operation — and pairs in only one demand reduce to
            # ``new`` / ``-old`` exactly.  Exact-zero diffs are dropped on
            # both paths (np.nonzero there, the mask here), and np.unique
            # returns pair ids sorted = the dense row-major order.
            os_, od_, ov = old.mp_coo()
            ns_, nd_, nv = new.mp_coo()
            keys = np.concatenate([
                ns_.astype(np.int64) * self._n + nd_,
                os_.astype(np.int64) * self._n + od_,
            ])
            contrib = np.concatenate([nv, -ov])
            uk, inv = np.unique(keys, return_inverse=True)
            dv = np.zeros(uk.size, dtype=np.float64)
            np.add.at(dv, inv, contrib)
            nzm = dv != 0.0
            pids, vals = uk[nzm], dv[nzm]
            self._compile_missing(pids)
        else:
            diff = new.mp - old.mp
            pids, vals = self._mp_arrays(diff)
        out = np.zeros(self._n_links, dtype=np.float64)
        out[: base.size] = base
        if gone:
            self._scatter_groups(out, gone, sign=-1.0)
        if added:
            self._scatter_groups(out, added, sign=1.0)
        self._scatter_mp(out, pids, vals)
        return out

    def comm_time_from_loads(self, loads: np.ndarray) -> float:
        """Bottleneck comm time of a precomputed load vector (the
        reference's ``load / (par * bandwidth)`` division, vectorized)."""
        if not loads.size:
            return 0.0
        return float(np.max(loads / self._cap[: loads.size]))

    def comm_times_from_loads(self, rows) -> np.ndarray:
        """Bottleneck comm times of ``K`` load vectors in one vectorized
        max (rows minted before the universe grew are zero-padded)."""
        rows = list(rows)
        if not rows:
            return np.zeros(0)
        n = self._n_links
        if not n:
            return np.zeros(len(rows))
        mat = np.zeros((len(rows), n), dtype=np.float64)
        for out, row in zip(mat, rows):
            out[: row.size] = row
        return np.max(mat / self._cap[:n], axis=1)

    def comm(self, demand: TrafficDemand) -> dict[str, float]:
        """Drop-in for :func:`~repro_torch.core.netsim.topoopt_comm_time` —
        ``{"comm_time", "bandwidth_tax"}`` — on the compiled arrays.
        ``comm_time`` is bit-identical to the reference; the tax agrees to
        float-reassociation level (~1e-15 relative)."""
        if self._sparse:
            touched, loads, pids, vals = self._eval_compact(demand)
            worst = self._bottleneck_compact(touched, loads)
        else:
            loads, pids, vals = self._eval(demand)
            worst = self.comm_time_from_loads(loads)
        logical = float(vals.sum())
        if logical > 0:
            tax = float(vals @ self._pair_tax[pids]) / logical
        else:
            tax = 1.0
        if self.hw.link_latency:
            worst = worst + self.hw.link_latency * demand_steps(demand)
        return {
            "comm_time": worst,
            "bandwidth_tax": tax,
        }

    def comm_time(self, demand: TrafficDemand) -> float:
        """Bottleneck comm time of ``demand`` — bit-identical to
        ``topoopt_comm_time(...)["comm_time"]`` (including the α latency
        term when ``hw.link_latency`` is set: same ``worst + α * steps``
        expression as the reference).  On the sparse path the bottleneck
        is taken over only the touched links (:meth:`_eval_compact`,
        bit-identical)."""
        if self._sparse:
            touched, loads, _, _ = self._eval_compact(demand)
            worst = self._bottleneck_compact(touched, loads)
        else:
            worst = self.comm_time_from_loads(self._eval(demand)[0])
        if self.hw.link_latency:
            worst = worst + self.hw.link_latency * demand_steps(demand)
        return worst

    def comm_times(self, demands) -> np.ndarray:
        """Batched pricing: bottleneck comm time of ``K`` demands in one
        vectorized max over a (K, n_links) load matrix (plus each demand's
        α latency term when ``hw.link_latency`` is set)."""
        demands = list(demands)
        if not demands:
            return np.zeros(0)
        rows = [self.loads(d) for d in demands]
        times = self.comm_times_from_loads(rows)
        if self.hw.link_latency:
            times = times + self.hw.link_latency * np.asarray(
                [demand_steps(d) for d in demands]
            )
        return times


def plan_evaluator(topo, hw: HardwareSpec) -> PlanEvaluator:
    """The compiled evaluator for ``topo``, memoized on the topology object
    (one per :class:`~repro_torch.core.netsim.HardwareSpec`).  Degraded topologies
    (:func:`~repro_torch.core.topology_finder.remove_pair` /
    :func:`~repro_torch.core.topology_finder.repair_topology`) are *new* objects,
    so they always recompile — no stale-cache hazard."""
    cache = getattr(topo, "_planevals", None)
    if cache is None:
        cache = {}
        topo._planevals = cache
    ev = cache.get(hw)
    if ev is None:
        ev = PlanEvaluator(topo, hw)
        cache[hw] = ev
    return ev


# ---------------------------------------------------------------------------
# Incremental multi-tenant objective (mcmc_search_jobset hot loop)
# ---------------------------------------------------------------------------


class JobSetEvaluator:
    """Incremental weighted-mean objective for a JobSet on a fixed topology.

    Caches one cluster-level link-load vector per (tenant, strategy); the
    shared comm time is the bottleneck of the *sum* of resident vectors, so
    a single-tenant MCMC move re-prices as ``total - old + new`` — two
    vector ops — instead of re-unioning and re-walking the whole JobSet.
    Matches the reference
    :func:`~repro_torch.core.strategy_search.evaluate_jobset` objective to 1e-9
    (per-tenant vector sums reassociate the union's float additions).

    ``demand_cache`` memoizes per-tenant *job-local* demand construction
    under the same ``(label, strategy, k)`` keys ``evaluate_jobset`` uses,
    so one (LRU-bounded) cache serves both paths across
    ``co_optimize_jobset`` rounds.
    """

    def __init__(
        self,
        jobset,
        topo,
        hw: HardwareSpec,
        overlap: float = 0.0,
        demand_cache=None,
        vector_cache_size: int | None = None,
        synth_missing_rings: bool = False,
        share_vector_cache: bool = True,
    ):
        self.jobset = jobset
        self.hw = hw
        self.overlap = overlap
        if vector_cache_size is None:
            vector_cache_size = int(
                os.environ.get("REPRO_VECTOR_CACHE_SIZE", "512")
            )
        # Price AllReduce groups the topology carries no rings for (a
        # tenant probed at a placement the topology was never built for)
        # as one synthetic ring over the members in placement order, each
        # hop routed like an MP pair — mirroring
        # ``iteration_tasks(synth_missing_rings=True)``.  Off by default:
        # the MCMC hot loops must keep skipping such groups exactly like
        # the reference walk.
        self.synth_missing_rings = synth_missing_rings
        self.ev = plan_evaluator(topo, hw)
        self.demand_cache = demand_cache if demand_cache is not None else {}
        if share_vector_cache:
            # Per-tenant load vectors depend only on (tenant, strategy,
            # placement, synth flag) for a fixed (topology, hw) — exactly
            # the scope of the memoized PlanEvaluator — so evaluators
            # built back-to-back on the same fabric (one per controller
            # replan) share one vector cache: an arrival or departure
            # re-prices only the tenants it actually touched.  Keys carry
            # the synth flag so synth/non-synth evaluators cannot poison
            # each other.
            shared = getattr(self.ev, "_tenant_vecs", None)
            if shared is None:
                shared = LRUCache(vector_cache_size)
                self.ev._tenant_vecs = shared
            self._vectors = shared
        else:
            self._vectors = LRUCache(vector_cache_size)
        self._tenant = {t.label: t for t in jobset.tenants}
        self._comp = {
            t.label: compute_time(t.flops_per_iteration, t.k, hw)
            for t in jobset.tenants
        }
        self.strategies: dict[str, object] = {}
        self._total: np.ndarray | None = None
        self._pending: tuple[str, object, np.ndarray] | None = None
        # Last propose_batch's (moves, rows, comms) for select().
        self._batch: tuple | None = None
        # Per-(label, strategy) schedule step counts (α latency term) —
        # topology- and placement-independent, so memoized flat.
        self._steps_memo: dict[tuple, float] = {}

    # -- cache telemetry -----------------------------------------------------

    def cache_stats(self) -> dict[str, dict]:
        """Hit/miss statistics of the vector and demand caches (the two
        LRU-bounded hot-loop caches a fleet run tunes via
        ``REPRO_VECTOR_CACHE_SIZE`` / ``REPRO_DEMAND_CACHE_SIZE``)."""
        out: dict[str, dict] = {}
        if isinstance(self._vectors, LRUCache):
            out["vectors"] = self._vectors.stats()
        if isinstance(self.demand_cache, LRUCache):
            out["demands"] = self.demand_cache.stats()
        return out

    def log_cache_stats(self, context: str = "") -> None:
        """DEBUG-log the cache hit rates (the online controller calls this
        after each migration screen)."""
        for name, s in self.cache_stats().items():
            logger.debug(
                "%s%s cache: %d/%d entries, %.1f%% hit rate "
                "(%d hits / %d misses)",
                f"{context}: " if context else "",
                name, s["size"], s["maxsize"], 100.0 * s["hit_rate"],
                s["hits"], s["misses"],
            )

    # -- per-tenant vectors --------------------------------------------------

    def _local_demand(self, t, strategy) -> TrafficDemand:
        key = (t.label, strategy, t.k)
        dem = self.demand_cache.get(key)
        if dem is None:
            dem = strategy.demand(t.spec, t.k)
            self.demand_cache[key] = dem
        return dem

    def tenant_loads(self, label: str, strategy) -> np.ndarray:
        """Cluster-level link-load vector of one tenant under ``strategy``
        at its resident placement (cached)."""
        return self.tenant_loads_at(
            label, strategy, self._tenant[label].servers
        )

    def tenant_loads_at(
        self, label: str, strategy, servers: tuple[int, ...]
    ) -> np.ndarray:
        """Cluster-level link-load vector of one tenant under ``strategy``
        embedded at an arbitrary candidate placement ``servers``.

        Vectors are cached per ``(label, strategy, servers)`` — the
        per-candidate demand cache of the placement co-search: scoring the
        same tenant under k candidate placements re-prices only the remap +
        scatter per placement (the job-local demand construction is shared
        through ``demand_cache``), and re-visiting a placement is a cache
        hit."""
        t = self._tenant[label]
        servers = tuple(int(s) for s in servers)
        key = (label, strategy, servers, self.synth_missing_rings)
        v = self._vectors.get(key)
        if v is None:
            dem = remap_demand(
                self._local_demand(t, strategy), servers, self.jobset.n
            )
            if self.synth_missing_rings:
                dem = self._with_synth_rings(dem)
            v = self.ev.loads(dem)
            self._vectors[key] = v
        return v

    def _with_synth_rings(self, dem: TrafficDemand) -> TrafficDemand:
        """Fold AllReduce groups without rings on this topology into MP
        entries along one synthetic ring over the members (the bytes the
        engine would actually route for them), leaving ringed groups to the
        exact incidence path."""
        missing = [
            g for g in dem.allreduce
            if len(g.members) > 1 and g.nbytes > 0
            and not self.ev.topo.rings.get(g.members)
        ]
        if not missing:
            return dem
        out = TrafficDemand(n=dem.n, mp=dem.mp.copy())
        out.allreduce = [g for g in dem.allreduce if g not in missing]
        for g in missing:
            k = len(g.members)
            per_link = 2.0 * (k - 1) / k * g.nbytes
            for i in range(k):
                out.add_mp(g.members[i], g.members[(i + 1) % k], per_link)
        return out

    def _steps(self, label: str, strategy) -> float:
        """Serial latency rounds of one tenant's demand under ``strategy``
        (:func:`~repro_torch.core.demand.demand_steps` of the job-local demand —
        equal to the remapped/unioned value, since placement preserves
        group sizes)."""
        key = (label, strategy)
        v = self._steps_memo.get(key)
        if v is None:
            v = demand_steps(
                self._local_demand(self._tenant[label], strategy)
            )
            self._steps_memo[key] = v
        return v

    def _move_steps(self, label: str, strategy) -> float:
        """Union step count of the current state with ``label`` moved to
        ``strategy`` — max over tenants, mirroring ``demand_steps`` of the
        union demand the reference walk prices."""
        if not self.hw.link_latency:
            return 0.0
        steps = 0.0
        for t in self.jobset.tenants:
            s = strategy if t.label == label else self.strategies[t.label]
            steps = max(steps, self._steps(t.label, s))
        return steps

    def _steps_of(self, strategies: dict[str, object]) -> float:
        if not self.hw.link_latency:
            return 0.0
        steps = 0.0
        for t in self.jobset.tenants:
            steps = max(steps, self._steps(t.label, strategies[t.label]))
        return steps

    def _objective(
        self, comm: float, steps: float = 0.0
    ) -> tuple[float, dict[str, float]]:
        if self.hw.link_latency:
            # Same ``worst + α * steps`` expression as the reference
            # (the cached load vectors carry only the β term).
            comm = comm + self.hw.link_latency * steps
        per_job: dict[str, float] = {}
        obj = 0.0
        for t in self.jobset.tenants:
            per_job[t.label] = iteration_time(
                comm, self._comp[t.label], overlap=self.overlap
            )
            obj += t.weight * per_job[t.label]
        return obj / self.jobset.total_weight, per_job

    # -- full + incremental evaluation ---------------------------------------

    def _full_total(self, strategies: dict[str, object]) -> np.ndarray:
        vectors = [
            self.tenant_loads(t.label, strategies[t.label])
            for t in self.jobset.tenants
        ]
        total = np.zeros(self.ev.n_links, dtype=np.float64)
        for v in vectors:
            total[: v.size] += v
        return total

    def objective_of(
        self, strategies: dict[str, object]
    ) -> tuple[float, dict[str, float]]:
        """Objective of an arbitrary strategy assignment, computed from the
        full sum of per-tenant vectors (no incremental lineage)."""
        return self._objective(
            self.ev.comm_time_from_loads(self._full_total(strategies)),
            self._steps_of(strategies),
        )

    def decomposed_objective_of(
        self, strategies: dict[str, object]
    ) -> tuple[float, dict[str, float]]:
        """Weighted *decomposed* objective of an arbitrary assignment: each
        tenant charged its own bottleneck comm time under weighted processor
        sharing of the links it loads
        (:func:`~repro_torch.core.strategy_search.tenant_comm_times` semantics).

        Computed from the cached per-tenant vectors with the exact
        expressions of the reference decomposition, so it matches
        :func:`~repro_torch.core.strategy_search.evaluate_jobset_decomposed` to
        the bit — the ``objective="decomposed"`` MCMC path needs compiled
        and reference chains to make identical fixed-seed decisions."""
        ts = self.jobset.tenants
        vecs = [
            self.tenant_loads(t.label, strategies[t.label]) for t in ts
        ]
        n_links = self.ev.n_links
        per_comm = {t.label: 0.0 for t in ts}
        if n_links:
            mat = np.zeros((len(vecs), n_links), dtype=np.float64)
            for row, v in zip(mat, vecs):
                row[: v.size] = v
            weights = np.asarray([t.weight for t in ts])
            active = mat > 0
            active_w = active.T @ weights
            caps = self.ev.caps
            for i, t in enumerate(ts):
                mask = active[i]
                if mask.any():
                    per_comm[t.label] = float(np.max(
                        mat[i, mask] * active_w[mask]
                        / (weights[i] * caps[mask])
                    ))
        if self.hw.link_latency:
            # α term: each tenant pays its own schedule's rounds — the
            # exact expression of the reference ``tenant_comm_times``.
            for t in ts:
                per_comm[t.label] = (
                    per_comm[t.label]
                    + self.hw.link_latency
                    * self._steps(t.label, strategies[t.label])
                )
        per_job: dict[str, float] = {}
        obj = 0.0
        for t in ts:
            per_job[t.label] = iteration_time(
                per_comm[t.label], self._comp[t.label], overlap=self.overlap
            )
            obj += t.weight * per_job[t.label]
        return obj / self.jobset.total_weight, per_job

    def set_strategies(
        self, strategies: dict[str, object]
    ) -> tuple[float, dict[str, float]]:
        """Full evaluation: adopt ``strategies`` as the current state and
        return ``(objective, per_job_iteration_times)``."""
        self.strategies = dict(strategies)
        self._total = self._full_total(strategies)
        self._pending = None
        return self._objective(
            self.ev.comm_time_from_loads(self._total),
            self._steps_of(strategies),
        )

    def _move_row(self, label: str, strategy) -> np.ndarray:
        """Load vector of the current state with ``label`` moved to
        ``strategy``: ``total - old + new``.  A no-op move returns the
        current total itself (bit-identical — keeps MCMC tie-acceptance
        aligned with the reference chain)."""
        if strategy == self.strategies[label]:
            return self._total
        v_old = self.tenant_loads(label, self.strategies[label])
        v_new = self.tenant_loads(label, strategy)
        row = self.ev.pad(self._total)
        if row is self._total:
            row = row.copy()
        row[: v_old.size] -= v_old
        row[: v_new.size] += v_new
        return row

    def placement_row(
        self, label: str, strategy, servers: tuple[int, ...]
    ) -> np.ndarray:
        """Load vector of the current state with tenant ``label`` re-seated
        at candidate placement ``servers`` under ``strategy``:
        ``total - old_vector + new_vector`` — the union demand never gets
        rebuilt.  Requires :meth:`set_strategies` first."""
        assert self._total is not None, "call set_strategies first"
        t = self._tenant[label]
        if tuple(servers) == t.servers and strategy == self.strategies[label]:
            return self._total
        v_old = self.tenant_loads(label, self.strategies[label])
        v_new = self.tenant_loads_at(label, strategy, servers)
        row = self.ev.pad(self._total)
        if row is self._total:
            row = row.copy()
        row[: v_old.size] -= v_old
        row[: v_new.size] += v_new
        return row

    def objective_at(
        self, label: str, strategy, servers: tuple[int, ...]
    ) -> float:
        """Weighted-mean objective with ``label`` moved to candidate
        placement ``servers`` (not adopted) — the fast screen of the
        migration / placement co-search."""
        return self._objective(
            self.ev.comm_time_from_loads(
                self.placement_row(label, strategy, servers)
            ),
            self._move_steps(label, strategy),
        )[0]

    def propose(
        self, label: str, strategy
    ) -> tuple[float, dict[str, float]]:
        """Price a single-tenant move without adopting it: the moved
        tenant's old vector is swapped for the new one against the cached
        total.  Call :meth:`accept` to adopt."""
        assert self._total is not None, "call set_strategies first"
        row = self._move_row(label, strategy)
        self._pending = (label, strategy, row)
        return self._objective(
            self.ev.comm_time_from_loads(row),
            self._move_steps(label, strategy),
        )

    def propose_batch(
        self, moves: list[tuple[str, object]]
    ) -> np.ndarray:
        """Objectives of ``K`` single-tenant moves in one vectorized pass
        (the batched MCMC mode).  Does not change the current state; pick
        the winner with :meth:`select` (its row is retained, not
        re-priced)."""
        assert self._total is not None, "call set_strategies first"
        rows = [self._move_row(label, strategy) for label, strategy in moves]
        comms = self.ev.comm_times_from_loads(rows)
        self._batch = (list(moves), rows, comms)
        return np.asarray([
            self._objective(float(c), self._move_steps(label, strategy))[0]
            for (label, strategy), c in zip(moves, comms)
        ])

    def select(self, index: int) -> tuple[float, dict[str, float]]:
        """Stage move ``index`` of the last :meth:`propose_batch` as the
        pending proposal (reusing its already-priced load row) and return
        its ``(objective, per_job)``.  Call :meth:`accept` to adopt."""
        moves, rows, comms = self._batch
        label, strategy = moves[index]
        self._pending = (label, strategy, rows[index])
        return self._objective(
            float(comms[index]), self._move_steps(label, strategy)
        )

    def accept(self) -> None:
        """Adopt the last proposed move as the current state."""
        assert self._pending is not None, "nothing proposed"
        label, strategy, total = self._pending
        self.strategies[label] = strategy
        self._total = total
        self._pending = None

    def union_for(self, strategies: dict[str, object]) -> TrafficDemand:
        """Cluster-level union demand under ``strategies`` (built only when
        a caller needs the demand object, e.g. for TopologyFinder)."""
        return self.jobset.union({
            t.label: self._local_demand(t, strategies[t.label])
            for t in self.jobset.tenants
        })

    def union(self) -> TrafficDemand:
        """Union demand of the *current* strategies."""
        return self.union_for(self.strategies)
