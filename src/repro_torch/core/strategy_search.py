"""Parallelization-strategy search (FlexFlow-style MCMC, §4.1 Comp x Comm).

The strategy space mirrors what matters for the paper's workloads: pure data
parallelism vs hybrid (embedding tables / experts placed on a subset of
hosts), including *which* hosts — device placement changes the MP traffic
matrix, which is exactly what the Comm x Topo plane consumes.

The simulated-annealing proposal/acceptance follows FlexFlow's MCMC: accept
better strategies always, worse ones with probability exp(-delta/T).

Multi-tenant mode (:func:`mcmc_search_jobset`): the state is one
:class:`Strategy` per resident tenant of a :class:`~repro_torch.core.workloads.JobSet`;
each move picks a tenant and proposes a per-job move in its *local* index
space (its MP pairs stay pinned to its placement), and the objective is the
weighted mean of per-job iteration times on the *shared* topology under the
union demand.
"""

from __future__ import annotations

import math
import os
import random
from dataclasses import dataclass, field, replace

import numpy as np

from .demand import TrafficDemand, demand_steps
from .netsim import (
    HardwareSpec,
    _iteration_time as iteration_time,
    compute_time,
    reference_comm_time,
)
from .planeval import JobSetEvaluator, LRUCache, plan_evaluator
from .topology_finder import Topology
from .workloads import JobSet, JobSpec, job_demand

# Cap on the per-tenant demand memo the jobset search loops share (entries
# are job-local TrafficDemands; long MCMC runs used to grow it unbounded).
DEMAND_CACHE_SIZE = 512


def demand_cache_size() -> int:
    """Capacity of the default per-tenant demand memo.  Fleet runs tune it
    without code edits via ``REPRO_DEMAND_CACHE_SIZE``; every search entry
    point also takes an explicit ``demand_cache`` kwarg which wins outright.
    """
    return int(os.environ.get("REPRO_DEMAND_CACHE_SIZE", str(DEMAND_CACHE_SIZE)))

# Acceptance decisions closer to the boundary than this (relative) are
# re-confirmed on a *pure* (path-independent) compiled evaluation: the
# incremental delta path carries ulp-level arithmetic lineage, and an MCMC
# move that leaves the objective mathematically unchanged must tie exactly
# — as it does on the reference path — or fixed-seed chains diverge.
_TIE_RTOL = 1e-12


@dataclass(frozen=True)
class Strategy:
    """A point in the Comp x Comm plane.

    ``schedule`` is the collective-schedule axis (ROADMAP item 2): the
    AllReduce schedule the strategy's demand compiles under
    (:mod:`repro_torch.core.schedules` — ``"ring"`` keeps mutable ring demand,
    byte-identical to the pre-schedule search space)."""

    mode: str  # "dp" | "hybrid"
    table_hosts: tuple[int, ...] = ()
    ep_group_size: int = 0
    schedule: str = "ring"

    def demand(self, job: JobSpec, n: int) -> TrafficDemand:
        hosts = self.table_hosts if self.mode == "hybrid" else None
        return job_demand(job, n, table_hosts=hosts,
                          ep_group_size=self.ep_group_size,
                          schedule=self.schedule)


def default_strategy(job: JobSpec) -> Strategy:
    """The cold-start point of the search: pure DP (EP groups of 8 for MoE)."""
    return Strategy(mode="dp", ep_group_size=8 if job.n_experts else 0)


@dataclass
class SearchResult:
    strategy: Strategy
    iter_time: float
    demand: TrafficDemand
    history: list[float] = field(default_factory=list)


@dataclass
class JobSetSearchResult:
    """Joint strategy search outcome for a shared cluster."""

    strategies: dict[str, Strategy]
    iter_time: float  # weighted mean of per-job iteration times
    demand: TrafficDemand  # union demand, cluster index space
    per_job: dict[str, float] = field(default_factory=dict)
    history: list[float] = field(default_factory=list)


def _evaluate(
    strategy: Strategy, job: JobSpec, topo: Topology, hw: HardwareSpec, overlap: float
) -> tuple[float, TrafficDemand]:
    demand = strategy.demand(job, topo.n)
    comm = reference_comm_time(topo, demand, hw)
    comp = compute_time(job.flops_per_sample * job.batch_per_gpu * topo.n, topo.n, hw)
    return iteration_time(comm, comp, overlap=overlap), demand


def _propose(
    strategy: Strategy,
    job: JobSpec,
    n: int,
    rng: random.Random,
    schedules: tuple[str, ...] | None = None,
) -> Strategy:
    moves = ["toggle_mode"]
    if job.n_tables:
        moves += ["move_host", "add_host", "drop_host"]
    if job.n_experts:
        moves += ["ep_size"]
    if schedules and len(schedules) > 1:
        # The collective-schedule axis joins the move set only when the
        # caller opted into searching it — a None/singleton ``schedules``
        # consumes the RNG exactly like the pre-schedule proposal kernel.
        moves += ["schedule"]
    move = rng.choice(moves)

    if move == "schedule":
        options = [s for s in schedules if s != strategy.schedule]
        return replace(strategy, schedule=rng.choice(options))
    if move == "toggle_mode":
        if strategy.mode == "dp" and job.n_tables:
            k = max(1, min(job.n_tables, n // 4))
            hosts = tuple(sorted(rng.sample(range(n), k)))
            return Strategy(mode="hybrid", table_hosts=hosts,
                            ep_group_size=strategy.ep_group_size,
                            schedule=strategy.schedule)
        return Strategy(mode="dp", ep_group_size=strategy.ep_group_size,
                        schedule=strategy.schedule)

    hosts = list(strategy.table_hosts) or [rng.randrange(n)]
    if move == "move_host":
        idx = rng.randrange(len(hosts))
        hosts[idx] = rng.randrange(n)
    elif move == "add_host" and len(hosts) < min(n, job.n_tables):
        hosts.append(rng.randrange(n))
    elif move == "drop_host" and len(hosts) > 1:
        hosts.pop(rng.randrange(len(hosts)))
    elif move == "ep_size":
        sizes = [s for s in (2, 4, 8, 16, 32) if n % s == 0 and s <= n]
        if sizes:
            return Strategy(
                mode=strategy.mode, table_hosts=strategy.table_hosts,
                ep_group_size=rng.choice(sizes),
                schedule=strategy.schedule,
            )
    return Strategy(
        mode="hybrid", table_hosts=tuple(sorted(set(hosts))),
        ep_group_size=strategy.ep_group_size,
        schedule=strategy.schedule,
    )


def _check_schedules(schedules: tuple[str, ...] | None) -> tuple[str, ...] | None:
    """Validate a searchable-schedule tuple (None = ring-only, the
    byte-identical default)."""
    if schedules is None:
        return None
    from .schedules import get_schedule

    schedules = tuple(schedules)
    for s in schedules:
        get_schedule(s)
    return schedules


def mcmc_search(
    job: JobSpec,
    topo: Topology,
    hw: HardwareSpec,
    iters: int = 200,
    temperature: float = 0.1,
    overlap: float = 0.0,
    seed: int = 0,
    init: Strategy | None = None,
    compiled: bool = True,
    proposals_per_step: int = 1,
    backend: str = "torch",
    chains: int = 1,
    pool_size: int = 64,
    schedules: tuple[str, ...] | None = None,
    temperatures: tuple[float, ...] | None = None,
    device=None,
) -> SearchResult:
    """Search the Comp x Comm plane for a fixed topology (§4.1).

    ``schedules`` opens the collective-schedule axis: a tuple of schedule
    names (:data:`repro_torch.core.schedules.SCHEDULES`) the proposal kernel may
    flip between alongside the strategy moves.  ``None`` (default) or a
    singleton keeps the pre-schedule move set — and the exact RNG stream —
    so fixed-seed results stay byte-identical to HEAD.

    On ``backend="numpy"``, ``compiled=True`` (default) prices candidates
    on the compiled evaluator
    (:func:`repro_torch.core.planeval.plan_evaluator`): demands and objective
    values are memoized per :class:`Strategy`, and each evaluation is the
    vectorized :meth:`PlanEvaluator.comm_time` — *bit-identical* to the
    reference walk, so the compiled chain makes exactly the decisions the
    ``compiled=False`` reference path makes at every fixed seed (including
    ``<=`` ties on moves that leave the objective unchanged).

    ``proposals_per_step=K > 1`` (compiled only) is the *batched* mode: K
    proposals are drawn, their load vectors re-priced as deltas against the
    incumbent (:meth:`PlanEvaluator.loads_delta`) in one vectorized pass,
    and the annealing rule is applied to the best of them.  It consumes the
    RNG differently, so its chain legitimately differs from ``K=1``.

    ``backend="torch"`` runs ``chains`` independent annealing chains over
    a pre-priced pool of ``pool_size`` strategies on ``device`` (the card
    when ``None``; :func:`repro_torch.core.planeval_torch.torch_mcmc_search`
    — the chain axis is a batch dimension, the iterations a loop of
    float64 tensor steps; ``device=None`` raises without a card).  It is
    the default, and the same chains as the JAX package's
    ``backend="jax"`` (its pool, its RNG streams, its annealing rule); a
    documented different chain from the NumPy walk.  ``backend="numpy"``
    is that host walk, byte-identical to the JAX package's default
    backend.  The returned ``iter_time`` is always re-priced on the
    bit-exact NumPy path.

    ``temperatures`` (torch only) replaces ``temperature`` with an
    ascending parallel-tempering ladder: each chain carries the whole
    ladder on device with even/odd neighbor swap moves
    (:meth:`~repro_torch.core.planeval_torch.TorchChainKernel.run_grid`).
    A singleton ladder ``(t,)`` replays the flat ``temperature=t`` chains
    exactly.
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(
            f"unknown mcmc_search backend {backend!r} (use 'numpy' or 'torch')"
        )
    if chains < 1:
        raise ValueError("chains must be >= 1")
    if temperatures is not None and backend != "torch":
        raise ValueError(
            "temperatures (tempering ladder) needs backend='torch'"
        )
    schedules = _check_schedules(schedules)
    if backend == "torch":
        from .planeval_torch import torch_mcmc_search

        return torch_mcmc_search(
            job, topo, hw, iters=iters, temperature=temperature,
            overlap=overlap, seed=seed, init=init, chains=chains,
            pool_size=pool_size, schedules=schedules,
            temperatures=temperatures, device=device,
        )
    if chains != 1:
        raise ValueError("chains > 1 needs backend='torch'")
    if proposals_per_step < 1:
        raise ValueError("proposals_per_step must be >= 1")
    if proposals_per_step > 1 and not compiled:
        raise ValueError("batched proposals need the compiled evaluator")
    rng = random.Random(seed)
    n = topo.n
    current = init or default_strategy(job)
    ev = plan_evaluator(topo, hw) if compiled else None
    comp = compute_time(job.flops_per_sample * job.batch_per_gpu * n, n, hw)
    demand_memo: dict[Strategy, TrafficDemand] = {}

    def demand_for(s: Strategy) -> TrafficDemand:
        d = demand_memo.get(s)
        if d is None:
            d = s.demand(job, n)
            demand_memo[s] = d
        return d

    time_memo: dict[Strategy, float] = {}

    def eval_time(s: Strategy) -> float:
        """Memoized bit-exact compiled evaluation — equals the reference
        ``_evaluate`` value to the bit for every strategy."""
        v = time_memo.get(s)
        if v is None:
            v = iteration_time(
                ev.comm_time(demand_for(s)), comp, overlap=overlap
            )
            time_memo[s] = v
        return v

    if compiled:
        cur_demand = demand_for(current)
        cur_time = eval_time(current)
        cur_loads = ev.loads(cur_demand) if proposals_per_step > 1 else None
    else:
        cur_loads = None
        cur_time, cur_demand = _evaluate(current, job, topo, hw, overlap)
    best, best_time, best_demand = current, cur_time, cur_demand
    history = [cur_time]

    for it in range(iters):
        if proposals_per_step > 1:
            cands = [
                _propose(current, job, n, rng, schedules=schedules)
                for _ in range(proposals_per_step)
            ]
            loads_list = [
                ev.loads_delta(cur_loads, cur_demand, demand_for(c))
                for c in cands
            ]
            comms = ev.comm_times_from_loads(loads_list)
            if hw.link_latency:
                # Same ``worst + α * steps`` expression as the reference
                # (the load-vector path prices only the β term).
                comms = comms + hw.link_latency * np.asarray(
                    [demand_steps(demand_for(c)) for c in cands]
                )
            times = [
                iteration_time(float(c), comp, overlap=overlap) for c in comms
            ]
            j = int(np.argmin(times))
            cand, cand_time, cand_loads = cands[j], times[j], loads_list[j]
            cand_demand = demand_for(cand)
        else:
            cand = _propose(current, job, n, rng, schedules=schedules)
            cand_loads = None
            if compiled:
                cand_demand = demand_for(cand)
                cand_time = eval_time(cand)
            else:
                cand_time, cand_demand = _evaluate(cand, job, topo, hw, overlap)
        t = temperature * max(cur_time, 1e-12)
        if cand_time <= cur_time or rng.random() < math.exp(
            -(cand_time - cur_time) / t
        ):
            current, cur_time, cur_demand = cand, cand_time, cand_demand
            cur_loads = cand_loads
            if cur_time < best_time:
                best, best_time, best_demand = current, cur_time, cur_demand
        history.append(cur_time)

    return SearchResult(
        strategy=best, iter_time=best_time, demand=best_demand, history=history
    )


# ---------------------------------------------------------------------------
# Multi-tenant: joint per-job strategy search on a shared topology
# ---------------------------------------------------------------------------


def _tenant_demands(
    strategies: dict[str, Strategy],
    jobset: JobSet,
    _demand_cache: dict | None,
) -> dict[str, TrafficDemand]:
    """Per-tenant *job-local* demands under ``strategies``, memoized in
    ``_demand_cache`` with the shared ``(label, strategy, k)`` keys."""
    demands: dict[str, TrafficDemand] = {}
    for t in jobset.tenants:
        s = strategies[t.label]
        if _demand_cache is None:
            demands[t.label] = s.demand(t.spec, t.k)
            continue
        key = (t.label, s, t.k)
        if key not in _demand_cache:
            _demand_cache[key] = s.demand(t.spec, t.k)
        demands[t.label] = _demand_cache[key]
    return demands


def tenant_comm_times(
    strategies: dict[str, Strategy],
    jobset: JobSet,
    topo: Topology,
    hw: HardwareSpec,
    _demand_cache: dict | None = None,
) -> dict[str, float]:
    """Per-tenant *own* bottleneck comm time on the shared fabric.

    The union objective charges every tenant the union's bottleneck; this
    decomposition instead gives each tenant its weighted share of every
    contended link: on link ``l`` a tenant holding ``v_i[l]`` of the load
    runs at ``cap_l * w_i / sum(w_j over tenants loading l)``, so its own
    comm time is ``max_l v_i[l] * sum_active_w_l / (w_i * cap_l)`` — the
    time its *own* bytes need under weighted processor sharing.  A tenant
    alone on all of its links gets exactly ``max_l v_i[l] / cap_l``; a
    tenant's decomposed time never exceeds the union comm time scaled by
    the inverse of its weight share, and at unit weights the heaviest
    tenant on the union bottleneck recovers the union time."""
    from .demand import remap_demand

    demands = _tenant_demands(strategies, jobset, _demand_cache)
    ev = plan_evaluator(topo, hw)
    vecs = [
        ev.loads(remap_demand(demands[t.label], t.servers, jobset.n))
        for t in jobset.tenants
    ]
    n_links = ev.n_links
    out: dict[str, float] = {}
    if not n_links:
        out = {t.label: 0.0 for t in jobset.tenants}
    else:
        mat = np.zeros((len(vecs), n_links), dtype=np.float64)
        for row, v in zip(mat, vecs):
            row[: v.size] = v
        weights = np.asarray([t.weight for t in jobset.tenants])
        active = mat > 0
        active_w = active.T @ weights  # per-link sum of contending weights
        caps = ev.caps
        for i, t in enumerate(jobset.tenants):
            mask = active[i]
            if not mask.any():
                out[t.label] = 0.0
                continue
            out[t.label] = float(np.max(
                mat[i, mask] * active_w[mask] / (weights[i] * caps[mask])
            ))
    if hw.link_latency:
        # α term: each tenant pays its *own* schedule's serial rounds.
        for t in jobset.tenants:
            out[t.label] = (
                out[t.label]
                + hw.link_latency * demand_steps(demands[t.label])
            )
    return out


def evaluate_jobset(
    strategies: dict[str, Strategy],
    jobset: JobSet,
    topo: Topology,
    hw: HardwareSpec,
    overlap: float = 0.0,
    _demand_cache: dict | None = None,
    compiled: bool = False,
    decompose: bool = False,
):
    """(weighted objective, union demand, per-job iteration times).

    The shared fabric serializes the union traffic: every job sees the fluid
    comm time of the *union* demand on the shared topology, plus its own
    compute on its shard.  The objective is the tenant-weight-weighted mean
    of per-job iteration times.

    ``_demand_cache`` memoizes per-tenant demand construction across calls
    (:class:`Strategy` is frozen/hashable): an MCMC move changes one
    tenant's strategy, so the other tenants' demands are reused verbatim.
    Pass an :class:`~repro_torch.core.planeval.LRUCache` to bound it across long
    runs — :func:`~repro_torch.core.alternating.co_optimize_jobset` shares one
    across all of its rounds.

    ``compiled=True`` prices the union on the compiled evaluator
    (:func:`~repro_torch.core.planeval.plan_evaluator`); the default is the
    reference :func:`~repro_torch.core.netsim.topoopt_comm_time`.  The true hot
    loop of :func:`mcmc_search_jobset` goes further and re-prices only the
    moved tenant's delta (:class:`~repro_torch.core.planeval.JobSetEvaluator`).

    ``decompose=True`` appends a fourth element: each tenant's *own*
    bottleneck comm time (:func:`tenant_comm_times`, weighted share of the
    contended links) reported alongside the union-charged per-job times —
    the objective itself is unchanged, so fixed-seed search results cannot
    shift."""
    demands = _tenant_demands(strategies, jobset, _demand_cache)
    union = jobset.union(demands)
    if compiled:
        comm = plan_evaluator(topo, hw).comm_time(union)
    else:
        comm = reference_comm_time(topo, union, hw)
    per_job: dict[str, float] = {}
    obj = 0.0
    for t in jobset.tenants:
        comp = compute_time(t.flops_per_iteration, t.k, hw)
        per_job[t.label] = iteration_time(comm, comp, overlap=overlap)
        obj += t.weight * per_job[t.label]
    if decompose:
        per_comm = tenant_comm_times(
            strategies, jobset, topo, hw, _demand_cache=_demand_cache
        )
        return obj / jobset.total_weight, union, per_job, per_comm
    return obj / jobset.total_weight, union, per_job


def evaluate_jobset_decomposed(
    strategies: dict[str, Strategy],
    jobset: JobSet,
    topo: Topology,
    hw: HardwareSpec,
    overlap: float = 0.0,
    _demand_cache: dict | None = None,
) -> tuple[float, dict[str, float]]:
    """(weighted decomposed objective, per-job iteration times).

    The decomposed counterpart of :func:`evaluate_jobset`: each tenant is
    charged its *own* bottleneck comm time under weighted processor sharing
    (:func:`tenant_comm_times`) instead of the union's, so heavy-weight
    tenants actually shape the objective.  This is the reference pricing of
    ``mcmc_search_jobset(objective="decomposed")`` — the compiled path
    (:meth:`~repro_torch.core.planeval.JobSetEvaluator.decomposed_objective_of`)
    computes the identical expressions from cached vectors and matches it
    to the bit."""
    comm = tenant_comm_times(
        strategies, jobset, topo, hw, _demand_cache=_demand_cache
    )
    per_job: dict[str, float] = {}
    obj = 0.0
    for t in jobset.tenants:
        comp = compute_time(t.flops_per_iteration, t.k, hw)
        per_job[t.label] = iteration_time(
            comm[t.label], comp, overlap=overlap
        )
        obj += t.weight * per_job[t.label]
    return obj / jobset.total_weight, per_job


def _mcmc_jobset_decomposed(
    jobset: JobSet,
    topo: Topology,
    hw: HardwareSpec,
    iters: int,
    temperature: float,
    overlap: float,
    seed: int,
    init: dict[str, Strategy] | None,
    compiled: bool,
    proposals_per_step: int,
    demand_cache: dict,
    schedules: tuple[str, ...] | None = None,
) -> JobSetSearchResult:
    """The ``objective="decomposed"`` annealing loop (so heavy tenants can
    shape the plan, which they cannot under the union objective).

    Every candidate state is priced *from scratch* on its per-tenant
    vectors — the decomposition has no incremental ``total - old + new``
    form (a move flips which tenants contend on which links) — so no
    tie-confirmation pass is needed: compiled and reference paths compute
    bit-identical objectives and make identical fixed-seed decisions."""
    rng = random.Random(seed)
    current: dict[str, Strategy] = {
        t.label: (init or {}).get(t.label) or default_strategy(t.spec)
        for t in jobset.tenants
    }
    if compiled:
        jse = JobSetEvaluator(
            jobset, topo, hw, overlap=overlap, demand_cache=demand_cache
        )

        def _eval(state):
            return jse.decomposed_objective_of(state)

    else:

        def _eval(state):
            return evaluate_jobset_decomposed(
                state, jobset, topo, hw, overlap,
                _demand_cache=demand_cache,
            )

    cur_obj, cur_per_job = _eval(current)
    best = dict(current)
    best_obj, best_per_job = cur_obj, cur_per_job
    history = [cur_obj]

    for _ in range(iters):
        if proposals_per_step > 1:
            cands = []
            for _k in range(proposals_per_step):
                t = jobset.tenants[rng.randrange(len(jobset.tenants))]
                cand = dict(current)
                cand[t.label] = _propose(
                    current[t.label], t.spec, t.k, rng, schedules=schedules
                )
                cands.append(cand)
            evals = [_eval(c) for c in cands]
            j = int(np.argmin([e[0] for e in evals]))
            cand, (cand_obj, cand_per_job) = cands[j], evals[j]
        else:
            t = jobset.tenants[rng.randrange(len(jobset.tenants))]
            cand = dict(current)
            cand[t.label] = _propose(
                current[t.label], t.spec, t.k, rng, schedules=schedules
            )
            cand_obj, cand_per_job = _eval(cand)
        temp = temperature * max(cur_obj, 1e-12)
        if cand_obj <= cur_obj or rng.random() < math.exp(
            -(cand_obj - cur_obj) / temp
        ):
            current, cur_obj, cur_per_job = cand, cand_obj, cand_per_job
            if cur_obj < best_obj:
                best, best_obj = dict(current), cur_obj
                best_per_job = cur_per_job
        history.append(cur_obj)

    union = jobset.union(_tenant_demands(best, jobset, demand_cache))
    return JobSetSearchResult(
        strategies=best, iter_time=best_obj, demand=union,
        per_job=best_per_job, history=history,
    )


def mcmc_search_jobset(
    jobset: JobSet,
    topo: Topology,
    hw: HardwareSpec,
    iters: int = 200,
    temperature: float = 0.1,
    overlap: float = 0.0,
    seed: int = 0,
    init: dict[str, Strategy] | None = None,
    compiled: bool = True,
    proposals_per_step: int = 1,
    demand_cache: dict | None = None,
    objective: str = "union",
    backend: str = "torch",
    chains: int = 1,
    pool_size: int = 64,
    schedules: tuple[str, ...] | None = None,
    temperatures: tuple[float, ...] | None = None,
    device=None,
) -> JobSetSearchResult:
    """Joint Comp x Comm search for a shared cluster (fixed topology).

    ``schedules`` opens the per-tenant collective-schedule axis (see
    :func:`mcmc_search`): proposal moves may flip a tenant's AllReduce
    schedule alongside its strategy moves.  ``None``/singleton keeps the
    pre-schedule move set and RNG stream byte-identical to HEAD.

    Each MCMC move picks one tenant and proposes a per-job move in its local
    index space (:func:`_propose` — table-host shuffles, EP-group resizes);
    acceptance follows the single-job annealing rule on the weighted
    objective.  Per-job MP pairs stay pinned to their placements: only the
    union's AllReduce groups are ring-mutable downstream.

    On ``backend="numpy"``, ``compiled=True`` (default) runs the
    *incremental* objective
    (:class:`~repro_torch.core.planeval.JobSetEvaluator`): per-tenant link-load
    vectors are cached, and a single-tenant move re-prices only
    ``total - old + new`` instead of re-unioning and re-walking the whole
    JobSet.  ``compiled=False`` is the reference path — fixed seeds must
    give identical results on both.  ``proposals_per_step=K > 1`` (compiled
    only) prices K proposals per step in one vectorized pass and anneals on
    the best of them (a different, documented, chain).

    ``demand_cache`` (default: a fresh LRU bounded at
    ``DEMAND_CACHE_SIZE``) memoizes per-tenant demand construction;
    :func:`~repro_torch.core.alternating.co_optimize_jobset` passes one cache
    shared across all of its rounds.

    ``objective="decomposed"`` anneals on the weighted *decomposed*
    per-tenant comm times (:func:`tenant_comm_times` semantics) instead of
    charging every tenant the union bottleneck, under which a
    heavy-weight tenant cannot pull the plan toward its own traffic.
    The default ``"union"`` preserves all existing goldens byte-for-byte.

    ``backend="torch"`` runs ``chains`` batched annealing chains over
    per-tenant pools of ``pool_size`` strategies on ``device`` (the card
    when ``None``; :func:`repro_torch.core.planeval_torch.torch_mcmc_search_jobset`);
    it is the default, and the reported result is re-priced on the
    bit-exact NumPy path.  ``backend="numpy"`` is the host walk,
    byte-identical to the JAX package's default backend.

    ``temperatures`` (torch only) swaps ``temperature`` for an ascending
    parallel-tempering ladder run through the grid chain program; a
    singleton ladder replays the flat chains' decisions exactly.
    """
    if not jobset.tenants:
        raise ValueError("mcmc_search_jobset needs at least one tenant")
    if objective not in ("union", "decomposed"):
        raise ValueError(f"unknown jobset objective {objective!r}")
    if backend not in ("numpy", "torch"):
        raise ValueError(
            f"unknown mcmc_search_jobset backend {backend!r} (use 'numpy' or 'torch')"
        )
    if chains < 1:
        raise ValueError("chains must be >= 1")
    if temperatures is not None and backend != "torch":
        raise ValueError(
            "temperatures (tempering ladder) needs backend='torch'"
        )
    schedules = _check_schedules(schedules)
    if backend == "torch":
        from .planeval_torch import torch_mcmc_search_jobset

        return torch_mcmc_search_jobset(
            jobset, topo, hw, iters=iters, temperature=temperature,
            overlap=overlap, seed=seed, init=init, chains=chains,
            pool_size=pool_size, objective=objective,
            demand_cache=demand_cache, schedules=schedules,
            temperatures=temperatures, device=device,
        )
    if chains != 1:
        raise ValueError("chains > 1 needs backend='torch'")
    if proposals_per_step < 1:
        raise ValueError("proposals_per_step must be >= 1")
    if proposals_per_step > 1 and not compiled:
        raise ValueError("batched proposals need the compiled evaluator")
    if demand_cache is None:
        demand_cache = LRUCache(demand_cache_size())
    if objective == "decomposed":
        return _mcmc_jobset_decomposed(
            jobset, topo, hw, iters, temperature, overlap, seed, init,
            compiled, proposals_per_step, demand_cache,
            schedules=schedules,
        )
    rng = random.Random(seed)
    current: dict[str, Strategy] = {
        t.label: (init or {}).get(t.label) or default_strategy(t.spec)
        for t in jobset.tenants
    }

    if compiled:
        jse = JobSetEvaluator(
            jobset, topo, hw, overlap=overlap, demand_cache=demand_cache
        )
        ref_memo: dict[tuple, float] = {}

        def _ref_jobset_obj(strategies: dict[str, Strategy]) -> float:
            """Bit-exact union objective (memoized) — tie-breaking
            authority for near-boundary acceptance (see
            :func:`mcmc_search`): the compiled union evaluation reproduces
            the reference walk to the bit, unlike the incremental
            per-tenant vector sums."""
            key = tuple(strategies[t.label] for t in jobset.tenants)
            v = ref_memo.get(key)
            if v is None:
                v = evaluate_jobset(
                    strategies, jobset, topo, hw, overlap,
                    _demand_cache=demand_cache, compiled=True,
                )[0]
                ref_memo[key] = v
            return v

        cur_obj, cur_per_job = jse.set_strategies(current)
        best = dict(current)
        best_obj, best_per_job = cur_obj, cur_per_job
        history = [cur_obj]

        for _ in range(iters):
            if proposals_per_step > 1:
                moves = []
                for _k in range(proposals_per_step):
                    t = jobset.tenants[rng.randrange(len(jobset.tenants))]
                    moves.append((
                        t.label,
                        _propose(current[t.label], t.spec, t.k, rng,
                                 schedules=schedules),
                    ))
                objs = jse.propose_batch(moves)
                j = int(np.argmin(objs))
                label, cand_s = moves[j]
                cand_obj, cand_per_job = jse.select(j)
            else:
                t = jobset.tenants[rng.randrange(len(jobset.tenants))]
                label = t.label
                cand_s = _propose(current[label], t.spec, t.k, rng,
                                  schedules=schedules)
                cand_obj, cand_per_job = jse.propose(label, cand_s)
            better = cand_obj <= cur_obj
            if (
                proposals_per_step == 1
                and abs(cand_obj - cur_obj)
                <= _TIE_RTOL * max(abs(cand_obj), abs(cur_obj))
            ):
                # Boundary case: confirm on the reference objective so
                # mathematical ties accept exactly like the reference chain.
                cand_state = dict(current)
                cand_state[label] = cand_s
                better = (
                    _ref_jobset_obj(cand_state)
                    <= _ref_jobset_obj(current)
                )
            temp = temperature * max(cur_obj, 1e-12)
            if better or rng.random() < math.exp(
                -(cand_obj - cur_obj) / temp
            ):
                jse.accept()
                current[label] = cand_s
                cur_obj, cur_per_job = cand_obj, cand_per_job
                improved = cur_obj < best_obj
                if (
                    proposals_per_step == 1
                    and abs(cur_obj - best_obj)
                    <= _TIE_RTOL * max(abs(cur_obj), abs(best_obj))
                ):
                    improved = (
                        _ref_jobset_obj(current) < _ref_jobset_obj(best)
                    )
                if improved:
                    best, best_obj = dict(current), cur_obj
                    best_per_job = cur_per_job
            history.append(cur_obj)

        return JobSetSearchResult(
            strategies=best, iter_time=best_obj,
            demand=jse.union_for(best), per_job=best_per_job,
            history=history,
        )

    cur_obj, cur_union, cur_per_job = evaluate_jobset(
        current, jobset, topo, hw, overlap, _demand_cache=demand_cache
    )
    best = dict(current)
    best_obj, best_union, best_per_job = cur_obj, cur_union, cur_per_job
    history = [cur_obj]

    for _ in range(iters):
        t = jobset.tenants[rng.randrange(len(jobset.tenants))]
        cand = dict(current)
        cand[t.label] = _propose(current[t.label], t.spec, t.k, rng,
                                 schedules=schedules)
        cand_obj, cand_union, cand_per_job = evaluate_jobset(
            cand, jobset, topo, hw, overlap, _demand_cache=demand_cache
        )
        temp = temperature * max(cur_obj, 1e-12)
        if cand_obj <= cur_obj or rng.random() < math.exp(
            -(cand_obj - cur_obj) / temp
        ):
            current, cur_obj = cand, cand_obj
            cur_union, cur_per_job = cand_union, cand_per_job
            if cur_obj < best_obj:
                best, best_obj = dict(current), cur_obj
                best_union, best_per_job = cur_union, cur_per_job
        history.append(cur_obj)

    return JobSetSearchResult(
        strategies=best, iter_time=best_obj, demand=best_union,
        per_job=best_per_job, history=history,
    )
