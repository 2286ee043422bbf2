"""Unified scenario-driven network simulation engine.

One facade over the three simulation granularities the paper's evaluation
uses, replacing the previously disjoint ``netsim`` / ``packetsim`` /
``ocs_reconfig`` entry points (which remain as thin shims):

* **Fluid bottleneck analysis** — :meth:`SimEngine.comm_time` /
  :meth:`SimEngine.iteration_time` price demands on the compiled plan
  evaluator (:mod:`repro_torch.core.planeval`; ``compiled=False`` falls back to
  the reference :func:`netsim.topoopt_comm_time` walk, §5.1 FlexNet
  analogue) for dedicated-cluster sweeps.
* **Event-driven max-min-fair flows** — :class:`FlowSimVec`, a vectorized
  rewrite of the old per-flow-dict ``packetsim.FlowSim`` inner loop: flow
  routes become link-index/count arrays, progressive filling runs on NumPy
  vectors, and event advancement is batched (FlexNetPacket analogue).
* **Scenario runs** — :class:`Scenario` + :meth:`SimEngine.run`: multi-job
  shared clusters with staggered arrivals, random link failures with
  reroute via the k-shortest-path machinery, straggler-skewed compute, and
  OCS reconfiguration epochs (Algorithm 5 topology rebuilds with a
  reconfiguration pause), none of which the seed modules could express.

Also hosts the vectorized ports of the benchmark inner loops
(:meth:`SimEngine.tree_times`, :meth:`SimEngine.dedicated_job_times`,
:meth:`SimEngine.reconfig_drain`) that ``benchmarks/bench_shared.py`` and
``bench_reconfig.py`` drive.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from .demand import TrafficDemand
from .netsim import (  # re-exported: the facade subsumes these
    HardwareSpec,
    _fat_tree_comm_time as fat_tree_comm_time,
    _ideal_switch_comm_time as ideal_switch_comm_time,
    _iteration_time as iteration_time,
    _topoopt_comm_time as topoopt_comm_time,
    compute_time,
    mp_flows,
)
from .ocs_reconfig import (
    _RECONFIG_LATENCY as RECONFIG_LATENCY,
    _RECONFIG_WINDOW as RECONFIG_WINDOW,
    _ocs_topology as ocs_topology,
)
from .planeval import plan_evaluator
from .routing import k_shortest_mp_routes
from .topology_finder import Topology, topology_finder

__all__ = [
    "PROPAGATION_DELAY",
    "Task",
    "SimResult",
    "FlowSimVec",
    "SimJob",
    "LinkFailure",
    "OCSPolicy",
    "FairnessPolicy",
    "WeightedFairness",
    "DeadlineFairness",
    "PlanUpdate",
    "EngineView",
    "ScenarioObserver",
    "Scenario",
    "ScenarioResult",
    "SimEngine",
    "links_from_topology",
    "iteration_tasks",
    # re-exports (the blessed, warning-free home of the legacy shim names)
    "HardwareSpec",
    "compute_time",
    "fat_tree_comm_time",
    "ideal_switch_comm_time",
    "iteration_time",
    "topoopt_comm_time",
    "ocs_topology",
    "topology_finder",
    "RECONFIG_WINDOW",
    "RECONFIG_LATENCY",
]

PROPAGATION_DELAY = 1e-6  # §5.1: link propagation delay 1 us


@dataclass
class Task:
    """A schedulable unit.  Either compute (duration) or comm (bytes+route).

    ``route`` holds the node path for flows; under a reconfigurable fabric
    only its endpoints are contractual — the engine re-derives the path on
    every topology change.  ``node`` attributes compute tasks to a server so
    straggler skew can find them.
    """

    tid: int
    kind: str  # "compute" | "flow"
    duration: float = 0.0  # compute seconds
    nbytes: float = 0.0  # flow size
    route: tuple[int, ...] = ()  # node path for flows
    deps: tuple[int, ...] = ()
    node: int = -1  # compute placement (straggler lookup)


@dataclass
class SimResult:
    makespan: float
    finish_times: dict[int, float] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Vectorized max-min-fair flow simulator
# ---------------------------------------------------------------------------


class _LinkTable:
    """Directed links -> dense indices; unknown links get infinite capacity
    (matching the old FlowSim's ``remaining_bw.get(link, inf)``)."""

    def __init__(self, link_bw: dict[tuple[int, int], float]):
        self.index: dict[tuple[int, int], int] = {}
        caps: list[float] = []
        for link, bw in link_bw.items():
            self.index[link] = len(caps)
            caps.append(float(bw))
        self.cap = np.asarray(caps, dtype=np.float64)

    def indices_for(self, route: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
        """(unique link idx, traversal count) for a node path; lazily grows
        the table for links outside the capacity map."""
        counts: dict[int, int] = {}
        for link in zip(route[:-1], route[1:]):
            li = self.index.get(link)
            if li is None:
                li = len(self.index)
                self.index[link] = li
                self.cap = np.append(self.cap, np.inf)
            counts[li] = counts.get(li, 0) + 1
        lids = np.fromiter(counts.keys(), dtype=np.int64, count=len(counts))
        cnts = np.fromiter(counts.values(), dtype=np.float64, count=len(counts))
        return lids, cnts


@dataclass
class _FlowState:
    task: Task
    remaining: float
    lids: np.ndarray  # unique link indices crossed
    cnts: np.ndarray  # traversal multiplicity per link
    hops: int  # len(route) - 1, for propagation delay
    rate: float = 0.0


def _maxmin_method() -> str:
    """Filling-loop selection: ``REPRO_MAXMIN_METHOD`` in {auto, heap,
    dense}; ``auto`` (default) uses the heap event queue once the link
    table reaches ``REPRO_SPARSE_MIN_LINKS`` links (default 0: always)."""
    import os

    return os.environ.get("REPRO_MAXMIN_METHOD", "auto")


def _sparse_min_links() -> int:
    import os

    return int(os.environ.get("REPRO_SPARSE_MIN_LINKS", "0"))


def _incidence_csr(flows: list[_FlowState]):
    """Inverted index link -> (flow, count), sorted by link for O(1)
    slices; stable sort keeps flows in ascending id within each link —
    the freeze order both filling loops share."""
    fid = np.concatenate(
        [
            np.full(f.lids.size, i, dtype=np.int64)
            for i, f in enumerate(flows)
            if f.lids.size
        ]
        or [np.empty(0, dtype=np.int64)]
    )
    lid = np.concatenate(
        [f.lids for f in flows if f.lids.size] or [np.empty(0, dtype=np.int64)]
    )
    cnt = np.concatenate(
        [f.cnts for f in flows if f.cnts.size] or [np.empty(0)]
    )
    order = np.argsort(lid, kind="stable")
    return lid[order], fid[order], cnt[order]


def _fill_dense(flows, rates, rem, users, alive, w, lid_s, fid_s, cnt_s, finite):
    """Reference filling loop: O(links) bottleneck scan per round.

    Kept as the baseline the heap loop (and the property tests /
    ``bench_fleet``) are pinned bit-identical against.
    """
    n_alive = int(alive.sum())
    while n_alive:
        used_idx = np.flatnonzero((users > 0) & finite)
        if used_idx.size == 0:
            break
        fair = rem[used_idx] / users[used_idx]
        b = int(used_idx[np.argmin(fair)])
        share = float(rem[b] / users[b])
        lo = np.searchsorted(lid_s, b, side="left")
        hi = np.searchsorted(lid_s, b, side="right")
        froze_any = False
        for fi, c_b in zip(fid_s[lo:hi], cnt_s[lo:hi]):
            if not alive[fi]:
                continue
            f = flows[fi]
            rates[fi] += share * w[fi] * c_b
            rem[f.lids] -= share * w[fi] * c_b * f.cnts
            users[f.lids] -= f.cnts * w[fi]
            alive[fi] = False
            n_alive -= 1
            froze_any = True
        if not froze_any:
            # Float residue: non-integer weights can leave a dust user
            # count on a link whose flows all froze (integer counts
            # subtract exactly, so the unweighted path never gets here).
            # Clear it or the filling loop would spin forever.
            users[b] = 0.0


def _fill_heap(flows, rates, rem, users, alive, w, lid_s, fid_s, cnt_s, finite):
    """Event-queue filling loop: lazy-deletion heap of (fair share, link).

    Only links whose residual actually changed are re-keyed, so a full
    fill costs O(nnz log nnz) in the flow->link incidence instead of the
    dense loop's O(rounds x links).  Bit-identical to :func:`_fill_dense`:
    the heap's (fair, lid) tuple order reproduces np.argmin's
    first-smallest-index tie-break, stored fair values are exactly the
    divisions the dense scan performs (a link's entry is invalidated by
    version counter whenever rem/users change), and the per-flow freeze
    arithmetic is byte-for-byte the same statements.
    """
    n_alive = int(alive.sum())
    version: dict[int, int] = {}
    heap: list[tuple[float, int, int]] = []
    for li in np.flatnonzero((users > 0) & finite):
        li = int(li)
        version[li] = 0
        heap.append((rem[li] / users[li], li, 0))
    heapq.heapify(heap)
    while n_alive and heap:
        share, b, ver = heapq.heappop(heap)
        if version.get(b) != ver or users[b] <= 0:
            continue  # stale entry (residual changed since push) or dust-cleared
        lo = np.searchsorted(lid_s, b, side="left")
        hi = np.searchsorted(lid_s, b, side="right")
        froze_any = False
        touched: list[np.ndarray] = []
        for fi, c_b in zip(fid_s[lo:hi], cnt_s[lo:hi]):
            if not alive[fi]:
                continue
            f = flows[fi]
            rates[fi] += share * w[fi] * c_b
            rem[f.lids] -= share * w[fi] * c_b * f.cnts
            users[f.lids] -= f.cnts * w[fi]
            alive[fi] = False
            n_alive -= 1
            froze_any = True
            touched.append(f.lids)
        if not froze_any:
            # Same float-residue dust clearing as the dense loop.
            users[b] = 0.0
            version[b] = ver + 1
            continue
        for li in np.unique(np.concatenate(touched)):
            li = int(li)
            if not finite[li]:
                continue
            v = version.get(li, 0) + 1
            version[li] = v
            if users[li] > 0:
                heapq.heappush(heap, (rem[li] / users[li], li, v))


def _max_min_rates(
    flows: list[_FlowState],
    cap: np.ndarray,
    weights: np.ndarray | None = None,
    method: str | None = None,
) -> np.ndarray:
    """Progressive-filling max-min fairness over a sparse incidence.

    Semantics match the legacy per-flow-dict loop: repeatedly find the link
    minimizing remaining_bw / n_users, hand each of its users that fair
    share (times traversal multiplicity), charge every link they cross, and
    freeze them.

    ``weights`` (per flow, default all ones) generalizes to *weighted*
    max-min: a link's fair share is split proportionally to flow weight
    (users count weight x traversal multiplicity).  With unit weights the
    arithmetic is bit-identical to the unweighted loop (multiplying by 1.0
    is exact), which is the ``FairnessPolicy`` golden invariant.

    Unknown links (infinite capacity, lazily added by :class:`_LinkTable`)
    are masked out of bottleneck selection entirely: they can never
    constrain a flow, and excluding them removes the old ``inf - inf ->
    nan`` residual update the legacy loop suppressed with ``errstate``.  A
    flow whose every link is unknown is unconstrained and finishes at
    infinite rate — the conclusion the legacy loop reached through an inf
    share, now reached without manufacturing nans.

    ``method`` ("heap" | "dense" | "auto" | None) picks the filling loop;
    None defers to ``REPRO_MAXMIN_METHOD`` / ``REPRO_SPARSE_MIN_LINKS``
    (see :func:`_maxmin_method`).  Both loops are bit-identical.
    """
    F = len(flows)
    rates = np.zeros(F)
    if F == 0:
        return rates
    w = np.ones(F) if weights is None else np.maximum(weights, 1e-12)
    rem = cap.astype(np.float64, copy=True)
    users = np.zeros(cap.size)
    alive = np.zeros(F, dtype=bool)
    for i, f in enumerate(flows):
        if f.lids.size:
            alive[i] = True
            users[f.lids] += f.cnts * w[i]
    lid_s, fid_s, cnt_s = _incidence_csr(flows)
    finite = np.isfinite(cap)

    if method is None or method == "auto":
        env = _maxmin_method() if method is None else "auto"
        if env == "auto":
            env = "heap" if cap.size >= _sparse_min_links() else "dense"
        method = env
    fill = _fill_heap if method == "heap" else _fill_dense
    fill(flows, rates, rem, users, alive, w, lid_s, fid_s, cnt_s, finite)

    # Flows still alive cross only unknown (inf-capacity) links: they are
    # unconstrained.  (A flow with any finite link would have kept that
    # link's user count positive, so the loop could not have ended.)
    if alive.any():
        for i in np.flatnonzero(alive):
            f = flows[int(i)]
            if not finite[f.lids].any():
                rates[i] = np.inf
    return rates


class FlowSimVec:
    """Event-driven max-min fair flow simulator over a task graph.

    Drop-in for the legacy ``packetsim.FlowSim`` (same task/result types,
    same event semantics — one completion per event, compute wins time
    ties), but the per-event work is NumPy: rate allocation runs on
    flows x links arrays and ETA selection on vectors.
    """

    def __init__(self, link_bandwidth: dict[tuple[int, int], float]):
        self.link_bw = dict(link_bandwidth)

    def run(self, tasks: list[Task], start_time: float = 0.0) -> SimResult:
        table = _LinkTable(self.link_bw)
        pending_deps = {t.tid: set(t.deps) for t in tasks}
        dependents: dict[int, list[Task]] = {}
        for t in tasks:
            for d in t.deps:
                dependents.setdefault(d, []).append(t)
        finish_times: dict[int, float] = {}
        active: list[_FlowState] = []
        compute_heap: list[tuple[float, int]] = []
        now = start_time

        def release(tid: int, t_done: float) -> list[Task]:
            finish_times[tid] = t_done
            out = []
            for t in dependents.get(tid, ()):
                deps = pending_deps[t.tid]
                deps.discard(tid)
                if not deps and t.tid not in finish_times:
                    out.append(t)
            return out

        def admit(t: Task) -> None:
            if t.kind == "compute":
                heapq.heappush(compute_heap, (now + t.duration, t.tid))
            else:
                lids, cnts = table.indices_for(t.route)
                active.append(
                    _FlowState(
                        task=t,
                        remaining=max(t.nbytes, 1e-9),
                        lids=lids,
                        cnts=cnts,
                        hops=max(len(t.route) - 1, 0),
                    )
                )

        for t in tasks:
            if not t.deps:
                admit(t)

        while active or compute_heap:
            rates = _max_min_rates(active, table.cap)
            t_flow = np.inf
            next_idx = -1
            if active:
                remaining = np.fromiter(
                    (f.remaining for f in active), dtype=np.float64, count=len(active)
                )
                hops = np.fromiter(
                    (f.hops for f in active), dtype=np.float64, count=len(active)
                )
                with np.errstate(divide="ignore", invalid="ignore"):
                    etas = np.where(
                        rates > 0,
                        now + remaining / rates + PROPAGATION_DELAY * hops,
                        np.inf,
                    )
                next_idx = int(np.argmin(etas))
                t_flow = float(etas[next_idx])
            t_comp = compute_heap[0][0] if compute_heap else np.inf

            if not np.isfinite(t_comp) and not np.isfinite(t_flow):
                # Deadlock (disconnected route): finish flows instantly to
                # avoid hanging; callers treat this as a routing bug.
                for f in active:
                    for nt in release(f.task.tid, now):
                        admit(nt)
                active.clear()
                continue

            t_next = min(t_flow, t_comp)
            dt = t_next - now
            if active and dt > 0:
                remaining = np.maximum(0.0, remaining - rates * dt)
                for f, r in zip(active, remaining):
                    f.remaining = float(r)
            now = t_next

            newly: list[Task] = []
            if t_comp <= t_flow and compute_heap:
                _, tid = heapq.heappop(compute_heap)
                newly.extend(release(tid, now))
            else:
                done = active.pop(next_idx)
                newly.extend(release(done.task.tid, now))
            for t in newly:
                admit(t)

        return SimResult(makespan=now - start_time, finish_times=finish_times)


# ---------------------------------------------------------------------------
# Scenarios: shared clusters, failures, stragglers, OCS epochs
# ---------------------------------------------------------------------------


@dataclass
class SimJob:
    """One job's task graph, arriving at ``arrival`` seconds."""

    name: str
    tasks: list[Task]
    arrival: float = 0.0


@dataclass(frozen=True)
class LinkFailure:
    """Both directions of ``link`` die at ``time``.

    ``repair_time`` (absolute scenario seconds, strictly after ``time``)
    makes the fault transient: at that instant the pair's pre-failure
    capacity is restored and in-flight flows are re-pathed against the
    repaired fabric with their remaining bytes intact — the same
    byte-preserving reroute a failure applies.  ``None`` (the default)
    keeps the original permanent-failure semantics.
    """

    time: float
    link: tuple[int, int]
    repair_time: float | None = None

    def __post_init__(self):
        if self.repair_time is not None and self.repair_time <= self.time:
            raise ValueError(
                f"repair_time {self.repair_time} must be strictly after "
                f"the failure time {self.time}"
            )


@dataclass(frozen=True)
class OCSPolicy:
    """Periodic optical-circuit-switch reconfiguration (Algorithm 5)."""

    window: float = RECONFIG_WINDOW
    latency: float = RECONFIG_LATENCY
    degree: int = 4
    link_bandwidth: float = 100e9 / 8
    max_epochs: int = 10_000  # safety: stall-finish whatever is left after


class FairnessPolicy:
    """Per-job bandwidth weights for the progressive-filling loop.

    Static policies (``time_varying`` False) are queried once per flow at
    admission; set ``time_varying`` True (deadline-aware policies) to be
    re-queried on every rate recomputation with the current clock.  The
    base policy weighs every job 1.0 — by the weighted-filling arithmetic
    that is bit-identical to no policy at all (the golden invariant
    ``tests/test_multitenant.py`` pins).
    """

    time_varying = False

    def weight(self, job: str, now: float) -> float:
        return 1.0


@dataclass(frozen=True)
class WeightedFairness(FairnessPolicy):
    """Static per-job weights (e.g. :meth:`repro_torch.core.workloads.JobSet.weights`);
    jobs missing from the map get ``default``."""

    weights: dict[str, float] = field(default_factory=dict)
    default: float = 1.0

    def weight(self, job: str, now: float) -> float:
        return self.weights.get(job, self.default)


@dataclass(frozen=True)
class DeadlineFairness(FairnessPolicy):
    """Deadline-aware priority: a job's weight ramps from ``base`` up to
    ``base * max_boost`` linearly over the last ``horizon`` seconds before
    its deadline (and stays at the ceiling past it).  Jobs without a
    deadline keep ``base``."""

    time_varying = True

    deadlines: dict[str, float] = field(default_factory=dict)
    horizon: float = 1.0
    max_boost: float = 8.0
    base: float = 1.0

    def weight(self, job: str, now: float) -> float:
        deadline = self.deadlines.get(job)
        if deadline is None:
            return self.base
        slack = deadline - now
        if slack >= self.horizon:
            return self.base
        if slack <= 0:
            return self.base * self.max_boost
        ramp = 1.0 + (self.max_boost - 1.0) * (1.0 - slack / self.horizon)
        return self.base * ramp


@dataclass(frozen=True)
class MigrationRecord:
    """One tenant-migration decision (adopted or rejected), for run logs
    and :class:`ScenarioResult`.

    ``cost`` is the priced pause in seconds
    (:func:`repro_torch.core.costmodel.migration_cost` checkpoint-restore +
    churn-priced fiber moves); ``est_before`` / ``est_after`` are the
    probed objective on the incumbent vs the post-migration plan."""

    time: float
    tenant: str
    src: tuple[int, ...]  # old placement
    dst: tuple[int, ...]  # proposed placement
    est_before: float = float("nan")
    est_after: float = float("nan")
    cost: float = 0.0
    edges_moved: int = 0
    adopted: bool = False
    reason: str = ""


@dataclass
class PlanUpdate:
    """A mid-run plan mutation, returned by :class:`ScenarioObserver` hooks.

    ``links`` (when not ``None``) replaces the live fabric wholesale: the
    engine refreshes link capacities, clears the route cache, and re-resolves
    the path of every in-flight flow against the new fabric (endpoints are
    contractual, paths are not — flows keep their remaining bytes).  ``pause``
    charges an OCS-style reconfiguration stall: no flow makes progress for
    ``pause`` seconds from the moment the update is applied.  ``edges_moved``
    is the physical churn behind the update (fibers the patch panel had to
    re-seat) — reported, summed, in ``ScenarioResult.edges_moved``.

    A migration update (``migrations`` non-empty) is the same mechanism with
    provenance: the fabric swap came from re-seating whole tenants
    (:meth:`repro.core.online.JobSetController.rebalance`), its ``pause``
    includes their checkpoint-restore cost, and the per-tenant
    :class:`MigrationRecord`\\ s are surfaced, concatenated, in
    ``ScenarioResult.migrations``.
    """

    links: dict[tuple[int, int], float] | None = None
    pause: float = 0.0
    label: str = ""
    edges_moved: int = 0
    migrations: tuple[MigrationRecord, ...] = ()


@dataclass(frozen=True)
class EngineView:
    """Read-only snapshot handed to observer hooks.

    ``active_flows`` rows are ``(job, tid, src, dst, remaining_bytes)`` —
    enough to rebuild an unsatisfied-demand matrix for replanning.  Treat
    ``links`` and ``delivered`` as read-only; mutate the fabric only through
    a returned :class:`PlanUpdate`.
    """

    now: float
    links: dict[tuple[int, int], float]
    resident: tuple[str, ...]  # arrived jobs with outstanding tasks
    active_flows: tuple[tuple[str, int, int, int, float], ...]
    delivered: dict[str, float]
    n: int | None

    def unsatisfied_demand(self) -> np.ndarray:
        """(n, n) matrix of remaining bytes per in-flight endpoint pair."""
        assert self.n is not None, "EngineView.n required for demand matrix"
        m = np.zeros((self.n, self.n))
        for _, _, src, dst, rem in self.active_flows:
            m[src, dst] += rem
        return m


class ScenarioObserver:
    """Hook interface making plan mutation a first-class scenario event.

    :meth:`SimEngine.run` calls these at the matching event; any hook may
    return a :class:`PlanUpdate` to swap the fabric and/or charge a
    reconfiguration pause.  The default implementation is a no-op, so a
    scenario run with a silent observer is bit-identical to one without.

    ``next_check`` schedules observer-initiated events (periodic replans,
    degradation probes): return the absolute time of the next check, or
    ``inf`` for none.  After a check fires, the engine re-queries; return a
    strictly later time to avoid a stuck clock (the engine additionally
    refuses to fire two checks at the same instant).
    """

    def next_check(self, now: float) -> float:
        return float("inf")

    def on_arrival(self, view: EngineView, job: "SimJob") -> PlanUpdate | None:
        return None

    def on_departure(self, view: EngineView, job_name: str) -> PlanUpdate | None:
        return None

    def on_failure(
        self, view: EngineView, link: tuple[int, int]
    ) -> PlanUpdate | None:
        return None

    def on_repair(
        self, view: EngineView, link: tuple[int, int]
    ) -> PlanUpdate | None:
        """A transient failure's ``repair_time`` elapsed; the engine has
        already restored the pair's pre-failure capacity."""
        return None

    def on_check(self, view: EngineView) -> PlanUpdate | None:
        return None


@dataclass
class Scenario:
    """Everything one simulation needs: fabric, offered load, disruptions.

    ``links`` maps directed node pairs to capacity in bytes/s (parallel
    links pre-aggregated — see :func:`links_from_topology`).  With a
    ``reconfig`` policy the fabric is instead rebuilt from unsatisfied
    demand every window and ``links`` only seeds the initial state.
    """

    links: dict[tuple[int, int], float]
    jobs: list[SimJob]
    failures: tuple[LinkFailure, ...] = ()
    stragglers: dict[int, float] = field(default_factory=dict)
    reconfig: OCSPolicy | None = None
    n: int | None = None  # node count (required for reconfig rebuilds)
    # Per-job bandwidth weights (weighted max-min); None = plain max-min.
    fairness: FairnessPolicy | None = None
    # Checkpoint-restore cost in seconds, charged to a job each time the
    # fabric reconnects it after a partition stranded one of its flows
    # (price with :func:`repro_torch.core.costmodel.checkpoint_restart_s`).
    # Jobs absent from the map restart for free.
    restart_s: dict[str, float] = field(default_factory=dict)


@dataclass
class ScenarioResult:
    makespan: float
    job_finish: dict[str, float]  # job -> absolute finish time
    job_makespans: dict[str, float]  # job -> finish - arrival
    finish_times: dict[tuple[str, int], float]  # (job, tid) -> finish
    delivered: dict[str, float]  # job -> network bytes completed
    n_reconfigs: int = 0
    stalled: tuple[tuple[str, int], ...] = ()  # flows finished by deadlock
    n_replans: int = 0  # observer-applied PlanUpdates
    replan_times: tuple[float, ...] = ()
    edges_moved: int = 0  # physical fiber churn summed over PlanUpdates
    # Tenant migrations carried by applied PlanUpdates, in application order.
    migrations: tuple[MigrationRecord, ...] = ()
    # Fault accounting: seconds each job spent partition-stalled (an
    # unroutable flow, or blocked on a checkpoint-restore restart) and how
    # many times it restarted after reconnection.  Empty on fault-free runs.
    downtime: dict[str, float] = field(default_factory=dict)
    restarts: dict[str, int] = field(default_factory=dict)

    @property
    def goodput(self) -> dict[str, float]:
        """Network bytes delivered per wall-clock second, per job."""
        span = self.makespan if self.makespan > 0 else 1.0
        return {job: b / span for job, b in self.delivered.items()}

    def availability(self, job: str) -> float:
        """Fraction of the run the job was *not* partition-stalled."""
        if self.makespan <= 0:
            return 1.0
        return 1.0 - min(self.downtime.get(job, 0.0), self.makespan) / self.makespan


class _ScenarioFlow(_FlowState):
    """Flow with job attribution and reroutable endpoints."""

    def __init__(self, job: str, task: Task, lids, cnts, hops):
        super().__init__(task=task, remaining=max(task.nbytes, 1e-9),
                         lids=lids, cnts=cnts, hops=hops)
        self.job = job
        self.path: tuple[int, ...] = task.route
        self.weight = 1.0  # fairness weight (set at admission)


class SimEngine:
    """Facade over every simulation granularity the repo offers.

    Construct once (optionally with a :class:`HardwareSpec`) and reuse: the
    engine caches per-job topologies for dedicated-cluster sweeps.
    """

    def __init__(
        self,
        hw: HardwareSpec | None = None,
        compiled: bool = True,
        backend: str = "torch",
        device=None,
    ):
        self.hw = hw or HardwareSpec()
        # Fluid pricing path: the compiled plan evaluator
        # (:func:`repro_torch.core.planeval.plan_evaluator`, cached per topology)
        # by default; ``compiled=False`` forces the reference
        # :func:`~repro_torch.core.netsim.topoopt_comm_time` walk.
        self.compiled = compiled
        # ``backend="torch"`` prices fluid comm times on the batched device
        # evaluator (:func:`repro_torch.core.planeval_torch.torch_plan_evaluator`)
        # on ``device`` (the card when None, which raises without one) —
        # held to the NumPy path within
        # :data:`~repro_torch.core.planeval_torch.TORCH_EQUIV_RTOL`; it is
        # the default.  "numpy" keeps the bit-exact host pricing.
        if backend not in ("numpy", "torch"):
            raise ValueError(
                f"unknown SimEngine backend {backend!r} (use 'numpy' or 'torch')"
            )
        self.backend = backend
        self.device = device
        self._dedicated_cache: dict = {}
        # job name -> (src, dst, bytes) arrays in job-local index space,
        # shared by every tree_times call on this engine.
        self._tree_flow_cache: dict[str, tuple] = {}

    # -- fluid facade (netsim) ---------------------------------------------

    def comm_time(self, topo: Topology, demand: TrafficDemand) -> dict[str, float]:
        if self.backend == "torch":
            from .planeval_torch import torch_plan_evaluator

            return torch_plan_evaluator(topo, self.hw, self.device).comm(demand)
        if self.compiled:
            return plan_evaluator(topo, self.hw).comm(demand)
        return topoopt_comm_time(topo, demand, self.hw)

    def iteration_time(
        self,
        topo: Topology,
        demand: TrafficDemand,
        flops_per_iteration: float = 0.0,
        overlap: float = 0.0,
    ) -> float:
        """Fluid comm + compute for one training iteration on ``topo``."""
        comm = self.comm_time(topo, demand)["comm_time"]
        comp = (
            compute_time(flops_per_iteration, topo.n, self.hw)
            if flops_per_iteration
            else 0.0
        )
        return iteration_time(comm, comp, overlap=overlap)

    # -- flow-level facade (packetsim) -------------------------------------

    def flow_sim(self, link_bandwidth: dict[tuple[int, int], float]) -> FlowSimVec:
        return FlowSimVec(link_bandwidth)

    def flow_makespan(
        self,
        link_bandwidth: dict[tuple[int, int], float],
        tasks: list[Task],
        start_time: float = 0.0,
    ) -> SimResult:
        return FlowSimVec(link_bandwidth).run(tasks, start_time)

    # -- scenario runs ------------------------------------------------------

    def run(
        self, scenario: Scenario, observer: ScenarioObserver | None = None
    ) -> ScenarioResult:
        """Simulate a full scenario: staggered job arrivals sharing the
        fabric max-min fairly, link failures with k-shortest-path reroute,
        straggler-skewed compute, and optional OCS reconfiguration epochs.

        ``observer`` (a :class:`ScenarioObserver`) receives arrival /
        departure / failure / check events and may return a
        :class:`PlanUpdate` to mutate the fabric mid-run — the mechanism
        behind :class:`repro.core.online.ReoptController`.  With no observer
        (or a silent one) the run is identical to the plain engine.
        """
        table = _LinkTable(scenario.links)
        live = {l: c for l, c in scenario.links.items() if c > 0}
        reconfig = scenario.reconfig
        if reconfig is not None:
            assert scenario.n is not None, (
                "Scenario.n is required when an OCS reconfiguration policy "
                "is set (topology rebuilds need the node count)"
            )

        jobs = sorted(scenario.jobs, key=lambda j: j.arrival)
        names = [j.name for j in jobs]
        assert len(set(names)) == len(names), "SimJob names must be unique"
        jobs_by_name = {j.name: j for j in jobs}
        arrivals = [(j.arrival, i) for i, j in enumerate(jobs)]
        failures = sorted(scenario.failures, key=lambda f: f.time)
        fail_i = 0
        arr_i = 0
        # Transient faults: repairs fire in their own time order, restoring
        # the capacity snapshot the matching failure took (``cut_caps``).
        repairs = sorted(
            (f for f in failures if f.repair_time is not None),
            key=lambda f: f.repair_time,
        )
        rep_i = 0
        cut_caps: dict[tuple[int, int], dict[tuple[int, int], float]] = {}

        pending: dict[tuple[str, int], set[int]] = {}
        dependents: dict[tuple[str, int], list[Task]] = {}
        for j in jobs:
            for t in j.tasks:
                pending[(j.name, t.tid)] = set(t.deps)
                for d in t.deps:
                    dependents.setdefault((j.name, d), []).append(t)

        finish: dict[tuple[str, int], float] = {}
        delivered: dict[str, float] = {j.name: 0.0 for j in jobs}
        stalled: list[tuple[str, int]] = []
        active: list[_ScenarioFlow] = []
        compute_heap: list[tuple[float, int, str, int]] = []
        seq = 0
        now = 0.0
        n_reconfigs = 0
        n_replans = 0
        edges_moved = 0
        replan_times: list[float] = []
        migrations: list[MigrationRecord] = []
        fairness = scenario.fairness
        # Observer bookkeeping: departure detection + check scheduling.
        outstanding: dict[str, int] = {j.name: len(j.tasks) for j in jobs}
        arrived: set[str] = set()
        departed: list[str] = []
        last_check = -np.inf
        # Partition-survival accounting.  ``track_faults`` flips on the
        # first unroutable flow and stays off for fault-free runs, which
        # therefore never touch any of this state (bit-identity invariant).
        downtime: dict[str, float] = {}
        restarts: dict[str, int] = {}
        restart_until: dict[str, float] = {}
        partitioned: set[str] = set()
        track_faults = False

        # OCS epoch state: next rebuild boundary and pause end.
        next_rebuild = 0.0 if reconfig else np.inf
        pause_until = -np.inf
        # When no engine-side event can ever fire again (every flow
        # unroutable, nothing scheduled), the observer gets at most one
        # immediate rescue check per stall episode — enough for a replan to
        # reconnect the fabric, but scheduled checks alone cannot keep a
        # dead simulation spinning forever.
        stall_rescues = 1

        import networkx as nx

        route_cache: dict[tuple[int, int], tuple[int, ...] | None] = {}

        def live_graph() -> "nx.DiGraph":
            g = nx.DiGraph()
            if scenario.n:
                g.add_nodes_from(range(scenario.n))
            for (a, b), c in live.items():
                if c > 0:
                    g.add_edge(a, b)
            return g

        def resolve_route(src: int, dst: int) -> tuple[int, ...] | None:
            """Direct link if alive, else k-shortest-path on the survivors."""
            if (src, dst) in live:
                return (src, dst)
            cached = route_cache.get((src, dst), "miss")
            if cached != "miss":
                return cached
            g = live_graph()
            mp = np.zeros((max(g.number_of_nodes(), src + 1, dst + 1),) * 2)
            mp[src, dst] = 1.0
            try:
                routes = k_shortest_mp_routes(
                    nx.MultiDiGraph(g), mp, k=1
                ).get(src, dst)
            except nx.NodeNotFound:
                routes = []  # endpoint has no live links at all
            path = routes[0].path if routes else None
            route_cache[(src, dst)] = path
            return path

        def install_route(f: _ScenarioFlow) -> None:
            nonlocal track_faults
            src, dst = f.task.route[0], f.task.route[-1]
            path = resolve_route(src, dst)
            if path is None:
                track_faults = True
                f.path = ()
                f.lids = np.empty(0, dtype=np.int64)
                f.cnts = np.empty(0)
                f.hops = 0
                return
            f.path = path
            f.lids, f.cnts = table.indices_for(path)
            f.hops = len(path) - 1

        def admit(job: SimJob, t: Task) -> None:
            nonlocal seq
            if t.kind == "compute":
                factor = scenario.stragglers.get(t.node, 1.0)
                heapq.heappush(
                    compute_heap, (now + t.duration * factor, seq, job.name, t.tid)
                )
                seq += 1
            else:
                f = _ScenarioFlow(job.name, t, np.empty(0, dtype=np.int64),
                                  np.empty(0), 0)
                install_route(f)
                if fairness is not None:
                    f.weight = fairness.weight(job.name, now)
                active.append(f)

        def release(job_name: str, tid: int, t_done: float) -> None:
            finish[(job_name, tid)] = t_done
            outstanding[job_name] -= 1
            if outstanding[job_name] == 0:
                departed.append(job_name)
            job = jobs_by_name[job_name]
            for t in dependents.get((job_name, tid), ()):
                deps = pending[(job_name, t.tid)]
                deps.discard(tid)
                if not deps and (job_name, t.tid) not in finish:
                    admit(job, t)

        def refresh_partitions() -> None:
            """Recompute the partition-stalled job set after a route-changing
            event.  A resident job leaving the set (its last unroutable flow
            got a path back) restarts from checkpoint: the restart is
            counted, and ``scenario.restart_s`` seconds of blocked progress
            are charged via ``restart_until``."""
            stalled_now = {f.job for f in active if not f.path}
            for job in partitioned - stalled_now:
                if outstanding.get(job, 0) <= 0:
                    continue
                restarts[job] = restarts.get(job, 0) + 1
                pause = scenario.restart_s.get(job, 0.0)
                if pause > 0:
                    restart_until[job] = now + pause
            partitioned.clear()
            partitioned.update(stalled_now)

        def set_links(new_links: dict[tuple[int, int], float]) -> None:
            """Swap the live fabric: refresh capacities (dead links -> 0,
            new links appended), drop stale routes, re-path in-flight flows."""
            live.clear()
            for link, c in new_links.items():
                if c > 0:
                    live[link] = live.get(link, 0.0) + float(c)
            for link in list(table.index):
                table.cap[table.index[link]] = live.get(link, 0.0)
            for link, c in live.items():
                if link not in table.index:
                    table.index[link] = len(table.index)
                    table.cap = np.append(table.cap, c)
                else:
                    table.cap[table.index[link]] = c
            route_cache.clear()
            for f in active:
                install_route(f)
            if track_faults:
                refresh_partitions()

        def make_view() -> EngineView:
            return EngineView(
                now=now,
                links=dict(live),
                # Arrival order, not set order: observers must see the same
                # tuple regardless of PYTHONHASHSEED.
                resident=tuple(
                    j.name for j in jobs
                    if j.name in arrived and outstanding[j.name] > 0
                ),
                active_flows=tuple(
                    (f.job, f.task.tid, f.task.route[0], f.task.route[-1],
                     f.remaining)
                    for f in active
                ),
                delivered=dict(delivered),
                n=scenario.n,
            )

        def apply_update(update: PlanUpdate | None) -> None:
            nonlocal pause_until, n_replans, edges_moved
            if update is None:
                return
            if update.links is not None:
                set_links(update.links)
            if update.pause > 0:
                pause_until = max(pause_until, now + update.pause)
            n_replans += 1
            edges_moved += update.edges_moved
            migrations.extend(update.migrations)
            replan_times.append(now)

        def notify_departures() -> None:
            """Drain jobs that just finished their last task (observer hook)."""
            while departed:
                name = departed.pop(0)
                if observer is not None:
                    apply_update(observer.on_departure(make_view(), name))

        def rebuild_topology() -> None:
            """Algorithm 5 rebuild from unsatisfied demand (active flows)."""
            nonlocal n_reconfigs
            n = scenario.n
            assert n is not None, "Scenario.n required for OCS reconfiguration"
            remaining = np.zeros((n, n))
            for f in active:
                src, dst = f.task.route[0], f.task.route[-1]
                remaining[src, dst] += f.remaining
            g = ocs_topology(n, remaining, reconfig.degree)
            new_links: dict[tuple[int, int], float] = {}
            for a, b in g.edges():
                new_links[(a, b)] = (
                    new_links.get((a, b), 0.0) + reconfig.link_bandwidth
                )
            set_links(new_links)
            n_reconfigs += 1

        def apply_failure(link: tuple[int, int]) -> None:
            pair = (min(link), max(link))
            snap: dict[tuple[int, int], float] = {}
            for l in (link, (link[1], link[0])):
                if l in live:
                    snap[l] = live[l]
                    del live[l]
                if l in table.index:
                    table.cap[table.index[l]] = 0.0
            if snap:
                # Snapshot what the cut removed so a repair can restore it.
                cut_caps[pair] = snap
            route_cache.clear()
            dead = {link, (link[1], link[0])}
            for f in active:
                if any(hop in dead for hop in zip(f.path[:-1], f.path[1:])):
                    install_route(f)
            if track_faults:
                refresh_partitions()

        def apply_repair(link: tuple[int, int]) -> None:
            """Restore both directions of a failed pair to their pre-failure
            capacity and re-path flows that could improve (unroutable or
            detoured) — the byte-preserving reroute, in reverse."""
            snap = cut_caps.pop((min(link), max(link)), None)
            if snap is None:
                return
            for l, c in snap.items():
                live[l] = c
                if l in table.index:
                    table.cap[table.index[l]] = c
                else:
                    table.index[l] = len(table.index)
                    table.cap = np.append(table.cap, c)
            route_cache.clear()
            for f in active:
                if not f.path or len(f.path) > 2:
                    install_route(f)
            if track_faults:
                refresh_partitions()

        # Admit roots of jobs arriving at t=0 happens via the arrival queue.
        while active or compute_heap or arr_i < len(arrivals) or (
            fail_i < len(failures)
        ) or rep_i < len(repairs):
            in_pause = now < pause_until
            flow_w = None
            if fairness is not None and active and not in_pause:
                if fairness.time_varying:
                    for f in active:
                        f.weight = fairness.weight(f.job, now)
                flow_w = np.fromiter(
                    (f.weight for f in active),
                    dtype=np.float64, count=len(active),
                )
            blocked = None
            if restart_until and active and not in_pause:
                blocked = np.fromiter(
                    (restart_until.get(f.job, -np.inf) > now for f in active),
                    dtype=bool, count=len(active),
                )
                if not blocked.any():
                    blocked = None
            if in_pause:
                rates = np.zeros(len(active))
            elif blocked is not None:
                # Checkpoint-restore in progress: the restarting jobs' flows
                # make no progress; everyone else shares the fabric.
                sub = [f for f, b in zip(active, blocked) if not b]
                rates = np.zeros(len(active))
                if sub:
                    sub_w = flow_w[~blocked] if flow_w is not None else None
                    rates[~blocked] = _max_min_rates(
                        sub, table.cap, weights=sub_w
                    )
            else:
                rates = _max_min_rates(active, table.cap, weights=flow_w)
            t_flow = np.inf
            next_idx = -1
            if active and not in_pause:
                remaining = np.fromiter(
                    (f.remaining for f in active), dtype=np.float64,
                    count=len(active),
                )
                hops = np.fromiter(
                    (f.hops for f in active), dtype=np.float64, count=len(active)
                )
                with np.errstate(divide="ignore", invalid="ignore"):
                    etas = np.where(
                        rates > 0,
                        now + remaining / rates + PROPAGATION_DELAY * hops,
                        np.inf,
                    )
                next_idx = int(np.argmin(etas))
                t_flow = float(etas[next_idx])
            t_comp = compute_heap[0][0] if compute_heap else np.inf
            t_arr = arrivals[arr_i][0] if arr_i < len(arrivals) else np.inf
            t_fail = failures[fail_i].time if fail_i < len(failures) else np.inf
            t_rep = (
                repairs[rep_i].repair_time if rep_i < len(repairs) else np.inf
            )
            # A restart pause ending re-enables its job's flows: wake then.
            t_restart = np.inf
            if restart_until:
                pend = [u for u in restart_until.values() if u > now]
                if pend:
                    t_restart = min(pend)
                else:
                    restart_until.clear()
            # Clamp to now: a rebuild boundary that elapsed while only
            # compute was running fires immediately, not in the past.
            t_reconf = (
                max(next_rebuild, now)
                if active or arr_i < len(arrivals)
                else np.inf
            )
            t_pause_end = pause_until if in_pause else np.inf
            # Observer checks (periodic replans / degradation probes) only
            # fire while work remains; a check already fired at this time is
            # not re-armed until the observer advances its schedule.
            t_check = np.inf
            if observer is not None and (
                active or compute_heap or arr_i < len(arrivals)
            ):
                tc = observer.next_check(now)
                if tc > last_check:
                    t_check = max(tc, now)

            t_work = min(
                t_flow, t_comp, t_arr, t_fail, t_rep, t_restart, t_reconf,
                t_pause_end,
            )
            t_next = min(t_work, t_check)
            if not np.isfinite(t_work):
                if (
                    observer is not None
                    and np.isfinite(t_check)
                    and stall_rescues > 0
                ):
                    # One immediate rescue check: a replanning observer may
                    # reconnect the fabric; a silent one falls through to
                    # the stall-finish on the next pass.
                    stall_rescues -= 1
                    last_check = now
                    apply_update(observer.on_check(make_view()))
                    notify_departures()
                    continue
                # Deadlock: every remaining flow is unroutable.  Drop any
                # failure events that can never fire (non-finite times) —
                # they would otherwise keep the loop's while-condition true
                # with no event left to make progress.  (Pending repairs
                # keep t_work finite, so this branch means none remain.)
                fail_i = len(failures)
                for f in active:
                    stalled.append((f.job, f.task.tid))
                    release(f.job, f.task.tid, now)
                active.clear()
                partitioned.clear()
                restart_until.clear()
                notify_departures()
                continue
            stall_rescues = 1

            dt = t_next - now
            if active and not in_pause and dt > 0:
                remaining = np.maximum(0.0, remaining - rates * dt)
                for f, r in zip(active, remaining):
                    f.remaining = float(r)
            if track_faults and dt > 0:
                down = {f.job for f in active if not f.path}
                for job_name, until in restart_until.items():
                    if until > now and outstanding.get(job_name, 0) > 0:
                        down.add(job_name)
                for job_name in down:
                    downtime[job_name] = downtime.get(job_name, 0.0) + dt
            now = t_next

            # Event priority at equal times: arrival, failure, repair,
            # reconfig, check, pause-end, restart-end, compute, flow —
            # deterministic and arrival-first so new jobs contend for
            # bandwidth immediately.
            if t_arr <= t_next:
                job = jobs[arrivals[arr_i][1]]
                arr_i += 1
                arrived.add(job.name)
                for t in job.tasks:
                    if not t.deps:
                        admit(job, t)
                if track_faults:
                    # A job admitted onto a partitioned fabric starts
                    # stalled; register it so a later reconnect restarts it.
                    refresh_partitions()
                if observer is not None:
                    apply_update(observer.on_arrival(make_view(), job))
            elif t_fail <= t_next:
                failed_link = failures[fail_i].link
                apply_failure(failed_link)
                fail_i += 1
                if observer is not None:
                    apply_update(observer.on_failure(make_view(), failed_link))
            elif rep_i < len(repairs) and t_rep <= t_next:
                repaired_link = repairs[rep_i].link
                apply_repair(repaired_link)
                rep_i += 1
                if observer is not None:
                    apply_update(observer.on_repair(make_view(), repaired_link))
            elif reconfig is not None and t_reconf <= t_next:
                if n_reconfigs >= reconfig.max_epochs:
                    for f in active:
                        stalled.append((f.job, f.task.tid))
                        release(f.job, f.task.tid, now)
                    active.clear()
                    partitioned.clear()
                    restart_until.clear()
                    next_rebuild = np.inf
                    notify_departures()
                    continue
                pause_until = now + reconfig.latency
                rebuild_topology()
                next_rebuild = now + reconfig.window
            elif observer is not None and t_check <= t_next:
                last_check = now
                apply_update(observer.on_check(make_view()))
            elif in_pause and t_pause_end <= t_next:
                pass  # pause over; next iteration recomputes rates
            elif t_restart <= t_next:
                pass  # a restart pause ended; next pass unblocks its flows
            elif t_comp <= t_flow and compute_heap:
                _, _, job_name, tid = heapq.heappop(compute_heap)
                release(job_name, tid, now)
            else:
                done = active.pop(next_idx)
                delivered[done.job] += done.task.nbytes
                release(done.job, done.task.tid, now)
            notify_departures()

        job_finish = {}
        job_makespans = {}
        for j in jobs:
            ts = [finish.get((j.name, t.tid), j.arrival) for t in j.tasks]
            job_finish[j.name] = max(ts) if ts else j.arrival
            job_makespans[j.name] = job_finish[j.name] - j.arrival
        return ScenarioResult(
            makespan=max(job_finish.values(), default=0.0),
            job_finish=job_finish,
            job_makespans=job_makespans,
            finish_times=finish,
            delivered=delivered,
            n_reconfigs=n_reconfigs,
            stalled=tuple(stalled),
            n_replans=n_replans,
            replan_times=tuple(replan_times),
            edges_moved=edges_moved,
            migrations=tuple(migrations),
            downtime=dict(downtime),
            restarts=dict(restarts),
        )

    # -- vectorized benchmark inner loops -----------------------------------

    def dedicated_job_times(
        self,
        jobs: list,
        n: int,
        demand_fn,
        degree: int | None = None,
    ) -> np.ndarray:
        """Per-job iteration time on dedicated TopoOpt shards (no cross-job
        contention).  Topologies are cached by job name across calls."""
        degree = degree if degree is not None else self.hw.degree
        times = []
        for job in jobs:
            key = (job.name, n, degree)
            if key not in self._dedicated_cache:
                dem = demand_fn(job)
                topo = topology_finder(dem, degree)
                comm = self.comm_time(topo, dem)["comm_time"]
                comp = compute_time(
                    job.flops_per_sample * job.batch_per_gpu * n, n, self.hw
                )
                self._dedicated_cache[key] = comm + comp
            times.append(self._dedicated_cache[key])
        return np.asarray(times)

    def tree_times(
        self,
        jobs: list,
        n_servers: int,
        job_size: int,
        demand_fn,
        bandwidth_fraction: float = 1.0,
        oversub: float = 1.0,
        tor_radix: int = 16,
    ) -> np.ndarray:
        """Shared two-level tree with fragmented placement, fully vectorized.

        Link universe (encoded as dense ids): host->ToR uplinks [0, N),
        ToR->host downlinks [N, 2N), ToR->core [2N, 2N+T), core->ToR
        [2N+T, 2N+2T).  Per-job flows are translated to hop ids, loads
        accumulate with ``np.add.at`` across all jobs at once, and each
        job's comm time is a segmented max of load/capacity over its hops.
        """
        n_jobs = len(jobs)
        if n_jobs == 0:
            return np.zeros(0)
        N = n_servers
        T = -(-N // tor_radix)
        bw = self.hw.link_bandwidth * self.hw.degree * bandwidth_fraction
        core_cap = tor_radix * bw / oversub

        # Per unique job type: flows in job-local index space (cached on the
        # engine — identical across bandwidth_fraction/oversub sweeps).
        flow_cache = self._tree_flow_cache
        for job in jobs:
            if job.name in flow_cache:
                continue
            dem = demand_fn(job)
            a_l, b_l, nb = [], [], []
            for group in dem.allreduce:
                k = len(group.members)
                if k == 0:
                    continue
                per_link = 2.0 * (k - 1) / k * group.nbytes
                for idx in range(k):
                    a_l.append(group.members[idx])
                    b_l.append(group.members[(idx + 1) % k])
                    nb.append(per_link)
            for s, t, v in mp_flows(dem):
                a_l.append(s)
                b_l.append(t)
                nb.append(v)
            flow_cache[job.name] = (
                np.asarray(a_l, dtype=np.int64),
                np.asarray(b_l, dtype=np.int64),
                np.asarray(nb, dtype=np.float64),
            )

        # Translate every job's flows to global hop ids in one pass.
        hop_ids, hop_bytes, hop_job = [], [], []
        for j, job in enumerate(jobs):
            a_l, b_l, nb = flow_cache[job.name]
            if a_l.size == 0:
                continue
            sa = (a_l * n_jobs + j) % N
            sb = (b_l * n_jobs + j) % N
            ta = sa // tor_radix
            tb = sb // tor_radix
            same = ta == tb
            # Same-ToR flows: host-up(sa), tor-down(sb).
            # Cross-ToR flows add tor-up(ta) and core-down(tb).
            up = sa
            down = N + sb
            tor_up = 2 * N + ta
            core_down = 2 * N + T + tb
            ids = np.stack([up, tor_up, core_down, down], axis=1)
            valid = np.stack(
                [np.ones_like(same), ~same, ~same, np.ones_like(same)], axis=1
            )
            flat_ids = ids[valid]
            reps = valid.sum(axis=1)
            hop_ids.append(flat_ids)
            hop_bytes.append(np.repeat(nb, reps))
            hop_job.append(np.repeat(np.full(a_l.size, j, dtype=np.int64), reps))

        comm = np.zeros(n_jobs)
        if hop_ids:  # compute-only job mixes offer no flows at all
            ids = np.concatenate(hop_ids)
            load = np.zeros(2 * N + 2 * T)
            np.add.at(load, ids, np.concatenate(hop_bytes))

            cap = np.full(2 * N + 2 * T, bw)
            cap[2 * N:] = core_cap
            hop_time = load[ids] / cap[ids]
            np.maximum.at(comm, np.concatenate(hop_job), hop_time)

        comp = np.asarray(
            [
                compute_time(
                    job.flops_per_sample * job.batch_per_gpu * job_size,
                    job_size,
                    self.hw,
                )
                for job in jobs
            ]
        )
        return comm + comp

    def reconfig_drain(
        self,
        remaining: np.ndarray,
        n: int,
        degree: int,
        reconfig_latency: float,
        forwarding: bool,
        max_windows: int = 500,
    ) -> float:
        """Drain a demand matrix with periodic OCS rebuilds (Fig. 17).

        Vectorized port of the old ``bench_reconfig._drain_time``: the
        direct-circuit drain runs on edge arrays; host-based forwarding
        still walks shortest paths but against a per-window BFS cache.
        """
        import networkx as nx

        remaining = remaining.astype(np.float64).copy()
        window = min(RECONFIG_WINDOW, max(1e-3, 50.0 * reconfig_latency))
        t = 0.0
        for _ in range(max_windows):
            if remaining.sum() <= 1e-3:
                break
            g = ocs_topology(n, remaining, degree)
            t += reconfig_latency
            budget = window

            # Aggregate parallel circuits -> (srcs, dsts, caps) arrays.
            edges = np.asarray(list(g.edges()), dtype=np.int64)
            drained = np.zeros_like(remaining)
            spare: dict[tuple[int, int], float] = {}
            if edges.size:
                pairs, counts = np.unique(edges, axis=0, return_counts=True)
                srcs, dsts = pairs[:, 0], pairs[:, 1]
                caps = counts * self.hw.link_bandwidth
                move = np.minimum(remaining[srcs, dsts], caps * budget)
                drained[srcs, dsts] += move
                if forwarding:
                    room = caps * budget - move
                    spare = {
                        (int(a), int(b)): float(r)
                        for a, b, r in zip(srcs, dsts, room)
                    }

            if forwarding and edges.size:
                simple = nx.DiGraph(g)
                paths_from: dict[int, dict[int, list[int]]] = {}
                left = remaining - drained
                f_srcs, f_dsts = np.nonzero(left > 1e-6)
                direct = set(spare)
                for a, b in zip(f_srcs.tolist(), f_dsts.tolist()):
                    if (a, b) in direct:
                        continue
                    if a not in paths_from:
                        try:
                            paths_from[a] = nx.single_source_shortest_path(
                                simple, a
                            )
                        except nx.NodeNotFound:
                            paths_from[a] = {}
                    path = paths_from[a].get(b)
                    if path is None:
                        continue
                    links = list(zip(path[:-1], path[1:]))
                    room = min(spare.get(l, 0.0) for l in links)
                    move = min(remaining[a, b], room)
                    if move > 0:
                        drained[a, b] += move
                        for l in links:
                            spare[l] -= move
            remaining = np.maximum(remaining - drained, 0.0)
            t += budget
        return t


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def links_from_topology(
    topo: Topology, hw: HardwareSpec
) -> dict[tuple[int, int], float]:
    """Directed pair -> aggregate capacity (parallel links pooled)."""
    caps: dict[tuple[int, int], float] = {}
    for a, b in topo.graph.edges():
        caps[(a, b)] = caps.get((a, b), 0.0) + hw.link_bandwidth
    return caps


def iteration_tasks(
    topo: Topology,
    demand: TrafficDemand,
    compute_duration: float = 0.0,
    tid_offset: int = 0,
    synth_missing_rings: bool = False,
) -> list[Task]:
    """One training iteration's flows on ``topo``: AllReduce bytes chunked
    across each group's rings, MP bytes split over the routing table (with
    an endpoint-only fallback for unrouted pairs).  Prepend an optional
    compute task with no dependencies.

    ``synth_missing_rings`` covers AllReduce groups the topology was never
    built for (a tenant admitted onto an incumbent shared fabric without a
    replan): their bytes ride one synthetic ring over the group members in
    placement order, each hop an endpoint-only flow the engine routes over
    whatever fabric survives.  Off by default — the historical behaviour
    (and the single-job golden paths) silently skip such groups."""
    tasks: list[Task] = []
    tid = tid_offset
    if compute_duration > 0:
        tasks.append(Task(tid=tid, kind="compute", duration=compute_duration))
        tid += 1
    for group in demand.allreduce:
        rings = topo.rings.get(group.members, [])
        k = len(group.members)
        if k <= 1 or group.nbytes == 0.0:
            continue
        if not rings:
            if synth_missing_rings:
                per_link = 2.0 * (k - 1) / k * group.nbytes
                for i in range(k):
                    a = group.members[i]
                    b = group.members[(i + 1) % k]
                    tasks.append(
                        Task(tid=tid, kind="flow", nbytes=per_link, route=(a, b))
                    )
                    tid += 1
            continue
        per_link = 2.0 * (k - 1) / k * group.nbytes / len(rings)
        for ring in rings:
            for a, b in ring.edges():
                tasks.append(
                    Task(tid=tid, kind="flow", nbytes=per_link, route=(a, b))
                )
                tid += 1
    srcs, dsts = np.nonzero(demand.mp)
    for s, t in zip(srcs.tolist(), dsts.tolist()):
        nb = float(demand.mp[s, t])
        routes = topo.routing.get(s, t)
        if not routes:
            tasks.append(Task(tid=tid, kind="flow", nbytes=nb, route=(s, t)))
            tid += 1
            continue
        share = nb / len(routes)
        for r in routes:
            tasks.append(Task(tid=tid, kind="flow", nbytes=share, route=r.path))
            tid += 1
    return tasks
