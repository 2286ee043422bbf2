"""Shared-cluster scheduler with look-ahead pre-provisioning (Appendix C).

A TopoOpt cluster is shardable: each job gets a disjoint set of servers and
a dedicated optical topology.  Patch panels reconfigure in minutes, so each
server interface is split Active/Look-ahead by a 1x2 mechanical switch: while
the Active plane runs current jobs, the Look-ahead plane pre-provisions the
*next* job's topology; when its servers free up, a microsecond 1x2 flip
activates it (no reconfiguration stall on the critical path).

This module simulates that policy: job arrivals -> server allocation ->
(pre-provision on look-ahead) -> flip at start -> release at completion,
charging the patch-panel latency only when a job starts before its
pre-provisioning finished.

Server selection is pluggable (``placement=``): lowest-id first fit (the
seed behaviour), best-fit ``"contiguous"`` blocks (fragmentation-resistant —
TotientPerms groups of contiguous ids map to physically adjacent patch-panel
ports), or any callable ``(free, k) -> servers`` — e.g. a closure over
:func:`repro_torch.core.online.place_arrival` for live-fabric-aware placement on a
degraded cluster.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Sequence

PATCH_PANEL_RECONFIG_S = 120.0  # minutes-scale robotic reconfiguration
FLIP_S = 1e-6  # 1x2 mechanical switch flip


@dataclass(frozen=True)
class JobRequest:
    jid: int
    arrival_s: float
    n_servers: int
    duration_s: float  # training time once started


@dataclass
class JobRecord:
    req: JobRequest
    servers: tuple[int, ...] = ()
    provision_ready_s: float = 0.0
    start_s: float = 0.0
    end_s: float = 0.0

    @property
    def queueing_s(self) -> float:
        return self.start_s - self.req.arrival_s


@dataclass
class ClusterState:
    n_servers: int
    free: set = field(default_factory=set)

    def __post_init__(self):
        if not self.free:
            self.free = set(range(self.n_servers))


def first_fit(free: set, k: int) -> tuple[int, ...]:
    """Lowest-id servers (the seed policy)."""
    return tuple(sorted(free))[:k]


def contiguous_fit(free: set, k: int) -> tuple[int, ...]:
    """Best-fit contiguous block of server ids.

    Prefers the *smallest* free run that fits (classic best-fit, leaves big
    runs intact for big jobs); when no single run fits, gathers from the
    largest runs first to minimize the number of fragments the job spans.
    """
    ids = sorted(free)
    runs: list[tuple[int, int]] = []  # (length, start)
    start = prev = None
    for v in ids:
        if prev is None or v != prev + 1:
            if start is not None:
                runs.append((prev - start + 1, start))
            start = v
        prev = v
    if start is not None:
        runs.append((prev - start + 1, start))
    fitting = [r for r in runs if r[0] >= k]
    if fitting:
        _, s = min(fitting)
        return tuple(range(s, s + k))
    out: list[int] = []
    for length, s in sorted(runs, key=lambda r: (-r[0], r[1])):
        take = min(k - len(out), length)
        out.extend(range(s, s + take))
        if len(out) == k:
            break
    return tuple(sorted(out))


_PLACEMENTS = {"first_fit": first_fit, "contiguous": contiguous_fit}


def simulate(
    n_servers: int,
    jobs: list[JobRequest],
    lookahead: bool = True,
    reconfig_s: float = PATCH_PANEL_RECONFIG_S,
    placement: str | Callable[[set, int], Sequence[int]] = "first_fit",
) -> list[JobRecord]:
    """Event-driven shard scheduler.

    With ``lookahead`` the next queued job's topology is provisioned on the
    spare plane as soon as its servers are *identifiable* (enough free or
    soon-to-free servers), so its start pays only the 1x2 flip.  Without it
    (single-plane), every start pays the full patch-panel reconfiguration.

    ``placement`` picks which free servers a starting job gets: a name from
    ``{"first_fit", "contiguous"}`` or a callable ``(free, k) -> servers``
    (must return ``k`` distinct members of ``free``).
    """
    place = _PLACEMENTS[placement] if isinstance(placement, str) else placement
    state = ClusterState(n_servers=n_servers)
    pending: list[JobRequest] = sorted(jobs, key=lambda j: j.arrival_s)
    running: list[tuple[float, int]] = []  # (end_time, jid) heap
    records: dict[int, JobRecord] = {}
    # "Since the topology and parallelization strategy are calculated
    # off-line, we already know the sequence of job arrivals" (App. C):
    # the look-ahead plane provisions jobs in arrival order, one at a time,
    # starting at t=0 — before the jobs even arrive.
    provisioned: dict[int, float] = {}
    if lookahead:
        plane_free = 0.0
        for req in pending:
            provisioned[req.jid] = plane_free + reconfig_s
            plane_free = provisioned[req.jid]
    now = 0.0
    queue: list[JobRequest] = []
    i = 0

    def try_start():
        nonlocal queue
        started = True
        while started and queue:
            started = False
            req = queue[0]
            if len(state.free) >= req.n_servers:
                servers = tuple(place(state.free, req.n_servers))
                if len(set(servers)) != req.n_servers or not (
                    set(servers) <= state.free
                ):
                    raise ValueError(
                        f"placement returned {servers!r}; need "
                        f"{req.n_servers} distinct servers from the free set"
                    )
                state.free -= set(servers)
                rec = records[req.jid]
                rec.servers = servers
                if lookahead and req.jid in provisioned:
                    ready = provisioned[req.jid]
                    rec.start_s = max(now, ready) + FLIP_S
                else:
                    rec.start_s = now + reconfig_s
                rec.provision_ready_s = provisioned.get(req.jid, rec.start_s)
                rec.end_s = rec.start_s + req.duration_s
                heapq.heappush(running, (rec.end_s, req.jid))
                queue = queue[1:]
                started = True

    while i < len(pending) or queue or running:
        next_arrival = pending[i].arrival_s if i < len(pending) else float("inf")
        next_finish = running[0][0] if running else float("inf")
        if next_arrival <= next_finish:
            now = next_arrival
            req = pending[i]
            i += 1
            records[req.jid] = JobRecord(req=req)
            queue.append(req)
        else:
            now = next_finish
            _, jid = heapq.heappop(running)
            state.free |= set(records[jid].servers)
        try_start()

    return [records[j.jid] for j in jobs]


def mean_queueing_overhead(records: list[JobRecord]) -> float:
    return sum(r.queueing_s for r in records) / max(len(records), 1)
