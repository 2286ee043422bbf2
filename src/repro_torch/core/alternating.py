"""Alternating optimization (paper §4.1, Fig. 6) — TopoOpt's outer loop.

The paper frames co-optimization as a search over three coupled dimensions
(computation, communication, topology) and alternates between two planes
until convergence or ``rounds`` iterations:

  Comp x Comm : parallelization-strategy search (FlexFlow-style MCMC,
                :func:`repro_torch.core.strategy_search.mcmc_search`) with the
                network topology held fixed;
  Comm x Topo : TopologyFinder (Algorithm 1,
                :func:`repro_torch.core.topology_finder.topology_finder`) on the
                traffic demand the chosen strategy induces.

Notation mapping (paper -> code):

  =====================  ==================================================
  paper                  here
  =====================  ==================================================
  ``S`` (strategy)       :class:`repro_torch.core.strategy_search.Strategy`
  ``G`` (topology)       :class:`repro_torch.core.topology_finder.Topology`
  ``T`` (traffic)        :class:`repro_torch.core.demand.TrafficDemand`
  ``t_iter`` (Eq. 1)     :func:`repro_torch.core.netsim.iteration_time`
  ``k`` rounds           ``rounds`` argument
  =====================  ==================================================

Online re-optimization (:mod:`repro.core.online`) re-enters this loop with
``warm_topology`` / ``warm_strategy`` (seed both planes from the incumbent
plan) and ``forbidden`` (failed fiber pairs excluded from every rebuild);
the cold-start defaults reproduce the paper's offline pipeline exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .demand import TrafficDemand
from .netsim import (
    HardwareSpec,
    _iteration_time as iteration_time,
    _topoopt_comm_time as topoopt_comm_time,
    compute_time,
)
from .planeval import JobSetEvaluator, LRUCache
from .simengine import SimEngine
from .strategy_search import (
    JobSetSearchResult,
    _check_schedules,
    demand_cache_size,
    SearchResult,
    Strategy,
    default_strategy,
    evaluate_jobset,
    evaluate_jobset_decomposed,
    mcmc_search,
    mcmc_search_jobset,
    tenant_comm_times,
)
from .topology_finder import Topology, topology_finder
from .workloads import JobSet, JobSpec


@dataclass
class CoOptResult:
    strategy: Strategy
    topology: Topology
    iter_time: float
    demand: TrafficDemand
    rounds: list[float] = field(default_factory=list)


@dataclass
class JobSetPlan:
    """A shared-cluster plan: one strategy per tenant + one shared topology.

    Duck-compatible with :class:`CoOptResult` where the online layer needs it
    (``topology`` / ``demand`` / ``iter_time``; ``strategy`` is the
    per-tenant dict).

    ``jobset`` / ``candidate_index`` carry placement-co-search provenance:
    the JobSet (tenant placements) this plan was optimized for and its index
    in the ``placement_candidates`` list it won from (0 when no candidate
    search ran).  ``per_job_comm`` is each tenant's *own* bottleneck comm
    time (:func:`~repro_torch.core.strategy_search.tenant_comm_times`) alongside
    the union-charged ``per_job`` iteration times."""

    strategies: dict[str, Strategy]
    topology: Topology
    iter_time: float  # weighted mean of per-job iteration times
    demand: TrafficDemand  # union demand, cluster index space
    per_job: dict[str, float] = field(default_factory=dict)
    rounds: list[float] = field(default_factory=list)
    jobset: "JobSet | None" = None
    candidate_index: int = 0
    per_job_comm: dict[str, float] = field(default_factory=dict)

    @property
    def strategy(self) -> dict[str, Strategy]:
        return self.strategies


def initial_topology(
    n: int, degree: int, forbidden: tuple[tuple[int, int], ...] = ()
) -> Topology:
    """Start from the naive stride-1 multi-ring (pure DP assumption).

    ``forbidden`` pairs (e.g. failed fibers) are excluded so the starting
    point is realizable on a degraded fabric."""
    from .demand import data_parallel_demand

    return topology_finder(data_parallel_demand(n, 1.0), degree,
                           forbidden=forbidden)


def evaluate(
    strategy: Strategy,
    topo: Topology,
    job: JobSpec,
    hw: HardwareSpec,
    overlap: float = 0.0,
    compiled: bool = True,
) -> float:
    """Iteration time of (strategy, topology) — thin shim over
    :meth:`repro_torch.core.simengine.SimEngine.iteration_time` (compiled plan
    evaluator by default; ``compiled=False`` forces the reference fluid
    path).  Always the host NumPy pricing: every backend's winners are
    re-priced here, so plans compare to the bit across backends and
    devices."""
    demand = strategy.demand(job, topo.n)
    return SimEngine(hw, compiled=compiled, backend="numpy").iteration_time(
        topo,
        demand,
        flops_per_iteration=job.flops_per_sample * job.batch_per_gpu * topo.n,
        overlap=overlap,
    )


def alternating_optimize(
    job: JobSpec,
    n: int,
    hw: HardwareSpec,
    rounds: int = 4,
    mcmc_iters: int = 150,
    overlap: float = 0.0,
    seed: int = 0,
    rel_tol: float = 1e-3,
    warm_topology: Topology | None = None,
    warm_strategy: Strategy | None = None,
    forbidden: tuple[tuple[int, int], ...] = (),
    compiled: bool = True,
    proposals_per_step: int = 1,
    backend: str = "torch",
    chains: int = 1,
    pool_size: int = 64,
    schedules: tuple[str, ...] | None = None,
    temperatures: tuple[float, ...] | None = None,
    device=None,
) -> CoOptResult:
    """TopoOpt's off-line co-optimization loop.

    ``schedules`` opens the collective-schedule axis in every round's
    strategy search (:func:`~repro_torch.core.strategy_search.mcmc_search`);
    ``None`` (default) keeps the ring-only move set byte-identical to HEAD.

    Online re-optimization (:mod:`repro.core.online`) re-enters this loop
    mid-run with a **warm start**: ``warm_topology`` / ``warm_strategy``
    seed both planes from the incumbent plan instead of the naive stride-1
    ring, and ``forbidden`` pins failed fiber pairs out of every topology
    rebuild.  A warm-started call also threads the incumbent into
    :func:`topology_finder`'s ``warm_start`` so ring strides that survived
    the disruption are kept (less physical churn on the patch panel).
    Cold calls (all three defaults) are byte-identical to the paper's
    offline pipeline.

    ``backend="torch"`` (default) runs each round's strategy search as
    ``chains`` batched chains on ``device`` (the card when ``None``, which
    raises without one; :mod:`repro_torch.core.planeval_torch`).
    ``backend="numpy"`` runs the host MCMC walk instead, byte-identical to
    the JAX package's default backend; ``compiled`` /
    ``proposals_per_step`` select its candidate-pricing path
    (:func:`~repro_torch.core.strategy_search.mcmc_search`): the compiled
    evaluator is the default and must match the ``compiled=False``
    reference at fixed seeds.  ``temperatures``
    (torch only) upgrades each round's search to a parallel-tempering
    ladder on the grid chain program — a singleton ladder replays the flat
    chains exactly.
    """
    warm = warm_topology is not None
    topo = (
        warm_topology
        if warm
        else initial_topology(n, hw.degree, forbidden=forbidden)
    )
    best: CoOptResult | None = None
    round_times: list[float] = []
    strategy_init: Strategy | None = warm_strategy

    for r in range(rounds):
        # Comp x Comm plane: search strategy on the fixed topology.
        res: SearchResult = mcmc_search(
            job, topo, hw, iters=mcmc_iters, overlap=overlap,
            seed=seed + r, init=strategy_init,
            compiled=compiled, proposals_per_step=proposals_per_step,
            backend=backend, chains=chains, pool_size=pool_size,
            schedules=schedules, temperatures=temperatures, device=device,
        )
        # Comm x Topo plane: rebuild the topology for the found demand.
        new_topo = topology_finder(
            res.demand, hw.degree, forbidden=forbidden,
            warm_start=topo if warm else None,
        )
        t_new = evaluate(res.strategy, new_topo, job, hw, overlap,
                         compiled=compiled)
        round_times.append(t_new)

        if best is None or t_new < best.iter_time:
            best = CoOptResult(
                strategy=res.strategy, topology=new_topo,
                iter_time=t_new, demand=res.demand, rounds=round_times,
            )
        # Converged?
        if len(round_times) >= 2 and (
            abs(round_times[-2] - round_times[-1])
            <= rel_tol * max(round_times[-2], 1e-12)
        ):
            break
        topo = new_topo
        strategy_init = res.strategy

    assert best is not None
    best.rounds = round_times
    return best


def _co_optimize_single(
    jobset: JobSet,
    hw: HardwareSpec,
    rounds: int,
    mcmc_iters: int,
    overlap: float,
    seed: int,
    rel_tol: float,
    warm_topology: Topology | None,
    warm_strategies: dict[str, Strategy] | None,
    forbidden: tuple[tuple[int, int], ...],
    compiled: bool,
    proposals_per_step: int,
    demand_cache,
    objective: str = "union",
    backend: str = "torch",
    chains: int = 1,
    pool_size: int = 64,
    schedules: tuple[str, ...] | None = None,
    temperatures: tuple[float, ...] | None = None,
    device=None,
) -> JobSetPlan:
    """The two-plane alternating loop for one fixed tenant placement —
    exactly the pre-placement-search ``co_optimize_jobset`` body."""
    warm = warm_topology is not None
    init: dict[str, Strategy] = {
        t.label: (warm_strategies or {}).get(t.label) or default_strategy(t.spec)
        for t in jobset.tenants
    }
    topo = (
        warm_topology
        if warm
        else topology_finder(
            jobset.union_for(init), hw.degree, forbidden=forbidden,
            pack="per_node",
        )
    )
    best: JobSetPlan | None = None
    round_times: list[float] = []
    strategy_init = init

    for r in range(rounds):
        res: JobSetSearchResult = mcmc_search_jobset(
            jobset, topo, hw, iters=mcmc_iters, overlap=overlap,
            seed=seed + r, init=strategy_init,
            compiled=compiled, proposals_per_step=proposals_per_step,
            demand_cache=demand_cache, objective=objective,
            backend=backend, chains=chains, pool_size=pool_size,
            schedules=schedules, temperatures=temperatures, device=device,
        )
        new_topo = topology_finder(
            res.demand, hw.degree, forbidden=forbidden,
            warm_start=topo if warm else None, pack="per_node",
        )
        if objective == "decomposed":
            # Round scoring must match what the chains annealed on, or the
            # outer loop would keep undoing the inner one's preferences.
            t_new, per_job = evaluate_jobset_decomposed(
                res.strategies, jobset, new_topo, hw, overlap,
                _demand_cache=demand_cache,
            )
            union = jobset.union_for(res.strategies)
        else:
            t_new, union, per_job = evaluate_jobset(
                res.strategies, jobset, new_topo, hw, overlap,
                _demand_cache=demand_cache, compiled=compiled,
            )
        round_times.append(t_new)

        if best is None or t_new < best.iter_time:
            best = JobSetPlan(
                strategies=dict(res.strategies), topology=new_topo,
                iter_time=t_new, demand=union, per_job=per_job,
                rounds=round_times, jobset=jobset,
            )
        if len(round_times) >= 2 and (
            abs(round_times[-2] - round_times[-1])
            <= rel_tol * max(round_times[-2], 1e-12)
        ):
            break
        topo = new_topo
        strategy_init = res.strategies

    assert best is not None
    best.rounds = round_times
    return best


def _co_optimize_fused(
    candidates: list[JobSet],
    order: list[int],
    hw: HardwareSpec,
    rounds: int,
    mcmc_iters: int,
    overlap: float,
    seed: int,
    rel_tol: float,
    warm_topology: Topology | None,
    warm_strategies: dict[str, Strategy] | None,
    forbidden: tuple[tuple[int, int], ...],
    demand_cache,
    objective: str,
    chains: int,
    pool_size: int,
    schedules: tuple[str, ...] | None,
    temperatures: tuple[float, ...],
    device=None,
) -> JobSetPlan:
    """Fused admission co-search: every screened placement candidate x the
    tempering ladder in **one** grid chain program per alternating round.

    Where the sequential path runs the whole alternating loop once per
    candidate (each round's winner re-materialized on host, every
    candidate paying its own chain programs), this loop prices one pool
    per tenant up front, stacks every candidate's link table into the
    padded grid (:func:`~repro_torch.core.planeval_torch.pack_jobset_grid`),
    and per round runs a single grid program on ``device``
    (:meth:`~repro_torch.core.planeval_torch.TorchChainKernel.run_grid`).  The winner
    hand-off between rounds stays on-device: each candidate's best
    (chain, rung) assignment — pool *indices*, valid across rounds because
    the pools are fixed — seeds the next round's grid directly; the host
    reads back only the small index array to rebuild each candidate's
    topology from its winner demand.  Only the final overall winner is
    re-priced on the bit-exact NumPy path.

    Search semantics differ from the sequential path (shared pools across
    rounds, device energies as round scores) — a documented different
    search, the JAX package's own fused path replayed.  Per-candidate best
    tracking scores each round's winner on the topology the chains
    searched on, so the tracked energy and the final NumPy re-price agree
    to :data:`~repro_torch.core.planeval_torch.TORCH_EQUIV_RTOL`.
    """
    from .planeval_torch import (
        _POOL_SEED_OFFSET,
        TorchChainKernel,
        check_temper_ladder,
        draw_grid_streams,
        draw_swap_streams,
        first_argmin,
        pack_jobset_grid,
        strategy_pool,
    )

    ladder = np.asarray(check_temper_ladder(temperatures), dtype=np.float64)
    M = ladder.size
    schedules = _check_schedules(schedules)
    subset = [candidates[ci] for ci in order]
    C = len(subset)
    tenants = subset[0].tenants
    T = len(tenants)
    init = {
        t.label: (warm_strategies or {}).get(t.label)
        or default_strategy(t.spec)
        for t in tenants
    }
    # One pre-priced pool per tenant, shared by every candidate and round
    # (the same seeds the sequential torch path uses for its first round).
    pools = [
        strategy_pool(
            t.spec, t.k, pool_size, seed + _POOL_SEED_OFFSET + i,
            init=init[t.label], schedules=schedules,
        )
        for i, t in enumerate(tenants)
    ]
    warm = warm_topology is not None
    topos = [
        warm_topology
        if warm
        else topology_finder(
            js.union_for(init), hw.degree, forbidden=forbidden,
            pack="per_node",
        )
        for js in subset
    ]

    cur_idx = np.zeros((C, T), dtype=np.int64)  # device array after round 0
    best_obj = np.full(C, np.inf)
    best_idx = np.zeros((C, T), dtype=np.int64)
    best_topo: list[Topology] = list(topos)
    round_objs: list[list[float]] = [[] for _ in range(C)]

    for r in range(rounds):
        V, caps, comps, weights, steps, _evs = pack_jobset_grid(
            subset, topos, hw, pools, overlap=overlap,
            demand_cache=demand_cache,
        )
        kernel = TorchChainKernel(
            V, caps, comps, weights, overlap=overlap, objective=objective,
            steps=steps, alpha=hw.link_latency, device=device,
        )
        t_idx, s_idx, u = draw_grid_streams(
            seed + r, C, chains, M, mcmc_iters, T, pool_size
        )
        su = draw_swap_streams(seed + r, C, chains, M, mcmc_iters)
        ba, bo, _hist = kernel.run_grid(
            cur_idx, ladder, t_idx, s_idx, u, su, device=True
        )
        # Per-candidate winning chain (the first of tied ones); the index
        # arrays stay on device as the next round's start states.
        k_star = first_argmin(bo, dim=1)
        c_ar = torch.arange(C, device=bo.device)
        cur_idx = ba[c_ar, k_star]
        win_idx = cur_idx.cpu().numpy()
        win_obj = bo[c_ar, k_star].cpu().numpy()
        new_topos = []
        for ci, js in enumerate(subset):
            round_objs[ci].append(float(win_obj[ci]))
            # Best tracking scores the winner on the topology it was
            # searched on (== the device energy); the rebuilt topology
            # feeds the next round and gets credited there if better.
            if win_obj[ci] < best_obj[ci]:
                best_obj[ci] = win_obj[ci]
                best_idx[ci] = win_idx[ci]
                best_topo[ci] = topos[ci]
            strategies = {
                t.label: pools[i][int(win_idx[ci, i])]
                for i, t in enumerate(js.tenants)
            }
            new_topos.append(topology_finder(
                js.union_for(strategies), hw.degree, forbidden=forbidden,
                warm_start=topos[ci] if warm else None, pack="per_node",
            ))
        topos = new_topos
        if r >= 1 and all(
            abs(ro[-2] - ro[-1]) <= rel_tol * max(ro[-2], 1e-12)
            for ro in round_objs
        ):
            break

    w = int(np.argmin(best_obj))  # ties resolve toward earlier candidates
    js = subset[w]
    strategies = {
        t.label: pools[i][int(best_idx[w, i])]
        for i, t in enumerate(js.tenants)
    }
    topo = best_topo[w]
    if objective == "decomposed":
        t_fin, per_job = evaluate_jobset_decomposed(
            strategies, js, topo, hw, overlap, _demand_cache=demand_cache
        )
        union = js.union_for(strategies)
    else:
        t_fin, union, per_job = evaluate_jobset(
            strategies, js, topo, hw, overlap,
            _demand_cache=demand_cache, compiled=True,
        )
    plan = JobSetPlan(
        strategies=strategies, topology=topo, iter_time=t_fin,
        demand=union, per_job=per_job, rounds=round_objs[w], jobset=js,
        candidate_index=order[w],
    )
    return plan


def co_optimize_jobset(
    jobset: JobSet,
    hw: HardwareSpec,
    rounds: int = 4,
    mcmc_iters: int = 150,
    overlap: float = 0.0,
    seed: int = 0,
    rel_tol: float = 1e-3,
    warm_topology: Topology | None = None,
    warm_strategies: dict[str, Strategy] | None = None,
    forbidden: tuple[tuple[int, int], ...] = (),
    compiled: bool = True,
    proposals_per_step: int = 1,
    placement_candidates: list[JobSet] | None = None,
    screen_candidates: int | None = None,
    objective: str = "union",
    backend: str = "torch",
    chains: int = 1,
    pool_size: int = 64,
    schedules: tuple[str, ...] | None = None,
    temperatures: tuple[float, ...] | None = None,
    device=None,
) -> JobSetPlan:
    """Multi-tenant alternating optimization: co-optimize every resident
    job's parallelization strategy against one *shared* topology.

    The same two-plane loop as :func:`alternating_optimize`, lifted to a
    :class:`~repro_torch.core.workloads.JobSet`: the Comp x Comm plane proposes
    per-job moves (:func:`~repro_torch.core.strategy_search.mcmc_search_jobset`,
    weighted-mean objective), and the Comm x Topo plane rebuilds one shared
    topology from the *union* demand with per-node degree packing
    (``topology_finder(pack="per_node")``) — per-job ring budgets land only
    on each job's own servers, per-job MP pairs stay pinned to their
    placements, and idle servers keep a connectivity ring for future
    arrivals.  ``warm_topology`` / ``warm_strategies`` / ``forbidden``
    mirror the single-job warm-start contract for online re-optimization.

    **Placement co-search** (``placement_candidates``): placement is the
    fourth co-optimized axis.  Pass a list of candidate JobSets — the same
    tenants under different server placements, e.g. one per
    :func:`~repro.core.online.place_candidates` admission variant — and the
    full alternating loop runs *per candidate* with the same seed, scoring
    each through the compiled :class:`~repro_torch.core.planeval.JobSetEvaluator`
    (per-tenant job-local demands are placement-independent, so one shared
    demand cache serves every candidate); the best full plan wins, ties
    resolved toward the earlier candidate (the greedy seed comes first).
    ``None`` — and a single-candidate list equal to ``jobset`` — follow the
    exact pre-search code path, so fixed-seed plans are unchanged.
    The winning plan records its ``jobset`` and ``candidate_index``
    (always the index into the *original* candidate list).

    ``screen_candidates=k`` bounds the cost of a wide candidate list: every
    candidate is first scored with the *incremental*
    :class:`~repro_torch.core.planeval.JobSetEvaluator` on its warm (or cold
    per-candidate) topology — synthetic rings for placements the incumbent
    fabric never carried, exactly the ``rebalance`` screen — and only the
    ``k`` best-screened candidates pay the full alternating loop.  ``None``
    (default) and any ``k >= len(candidates)`` run every candidate:
    byte-identical to the unscreened behaviour.

    ``objective="decomposed"`` anneals and scores rounds on the weighted
    decomposed per-tenant comm times
    (:func:`~repro_torch.core.strategy_search.evaluate_jobset_decomposed`);
    ``backend="torch"`` (default) / ``chains`` run each round's search as
    batched chains on ``device`` (the card when ``None``, which raises
    without one); ``backend="numpy"`` is the host walk, whose plans equal
    the JAX package's default-backend goldens.

    ``temperatures`` (torch only) is the **fused admission co-search**
    path: with two or more surviving candidates, the per-candidate Python
    loop below is replaced by one grid chain program per alternating
    round — every candidate x every ladder rung x every chain in one
    batch of tensors, the winner hand-off between rounds staying on the
    device, and only the final plan re-priced on the bit-exact NumPy path
    (:func:`_co_optimize_fused`, a documented different search gated on
    end quality).  With a single candidate the standard per-round loop
    runs with the ladder threaded into each round's search, so a
    singleton ladder replays the flat torch path exactly.

    One LRU-bounded per-tenant demand cache is shared across every round's
    MCMC and the final pricing (the caches used to be rebuilt per round);
    ``compiled`` / ``proposals_per_step`` select the candidate-pricing path
    exactly as in :func:`alternating_optimize`.  The winner additionally
    reports ``per_job_comm`` — each tenant's own decomposed bottleneck time
    (:func:`~repro_torch.core.strategy_search.tenant_comm_times`).
    """
    if placement_candidates is not None and not placement_candidates:
        raise ValueError("placement_candidates must be non-empty when given")
    candidates = (
        [jobset] if placement_candidates is None else list(placement_candidates)
    )
    labels = {t.label for t in jobset.tenants}
    for js in candidates:
        if {t.label for t in js.tenants} != labels:
            raise ValueError(
                "every placement candidate must carry the same tenant labels"
            )
    if not jobset.tenants:
        raise ValueError("co_optimize_jobset needs at least one tenant")
    if screen_candidates is not None and screen_candidates < 1:
        raise ValueError("screen_candidates must be >= 1 when given")
    demand_cache = LRUCache(demand_cache_size())

    order = list(range(len(candidates)))
    if screen_candidates is not None and screen_candidates < len(candidates):
        # Fast screen (bugfix: wide candidate lists used to pay the full
        # alternating loop per candidate): incremental evaluator pricing of
        # each candidate's warm-start state, survivors in original order so
        # the tie-toward-earlier contract below is unchanged.
        scores: list[tuple[float, int]] = []
        for ci, js in enumerate(candidates):
            init = {
                t.label: (warm_strategies or {}).get(t.label)
                or default_strategy(t.spec)
                for t in js.tenants
            }
            topo0 = (
                warm_topology
                if warm_topology is not None
                else topology_finder(
                    js.union_for(init), hw.degree, forbidden=forbidden,
                    pack="per_node",
                )
            )
            jse = JobSetEvaluator(
                js, topo0, hw, overlap=overlap, demand_cache=demand_cache,
                synth_missing_rings=True,
            )
            scores.append((jse.set_strategies(init)[0], ci))
        scores.sort()
        order = sorted(ci for _, ci in scores[:screen_candidates])

    if temperatures is not None and backend != "torch":
        raise ValueError(
            "temperatures (tempering ladder) needs backend='torch'"
        )
    if temperatures is not None and len(order) > 1:
        # Fused admission co-search: all surviving candidates x the
        # tempering ladder in one grid program per alternating round.
        best: JobSetPlan | None = _co_optimize_fused(
            candidates, order, hw, rounds, mcmc_iters, overlap, seed,
            rel_tol, warm_topology, warm_strategies, forbidden,
            demand_cache, objective=objective, chains=chains,
            pool_size=pool_size, schedules=schedules,
            temperatures=temperatures, device=device,
        )
    else:
        best = None
        for ci in order:
            plan = _co_optimize_single(
                candidates[ci], hw, rounds, mcmc_iters, overlap, seed,
                rel_tol, warm_topology, warm_strategies, forbidden,
                compiled, proposals_per_step, demand_cache,
                objective=objective, backend=backend, chains=chains,
                pool_size=pool_size, schedules=schedules,
                temperatures=temperatures, device=device,
            )
            plan.candidate_index = ci
            if best is None or plan.iter_time < best.iter_time:
                best = plan

    assert best is not None
    best.per_job_comm = tenant_comm_times(
        best.strategies, best.jobset, best.topology, hw,
        _demand_cache=demand_cache,
    )
    return best
