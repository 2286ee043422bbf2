"""Online re-optimization: dynamic TopoOpt reacting to failures and load
shifts, and topology-aware job placement, in the port.

The offline pipeline (:func:`repro_torch.core.alternating.alternating_optimize`)
computes one (strategy, topology, routing) plan and assumes the cluster never
changes.  :class:`repro_torch.core.simengine.SimEngine` already models the events
that make such a plan stale — fiber failures, job arrivals/departures,
stragglers — so this module closes the loop:

* :class:`ReoptPolicy` — *when* to re-optimize: on failure, on job
  arrival/departure (load shifts), periodically, or when a degradation probe
  sees the estimated iteration time exceed a tracked baseline, all gated by a
  hysteresis ``min_interval``.
* :class:`ReoptController` — *how*: a
  :class:`~repro_torch.core.simengine.ScenarioObserver` that pauses the fluid
  simulation (an OCS-style ``replan_latency`` stall), re-runs the alternating
  optimizer **warm-started from the incumbent plan** against the surviving
  fiber pairs and resident job, and resumes in-flight flows on the new
  topology/routes via a :class:`~repro_torch.core.simengine.PlanUpdate`.  When no
  replan triggers it still maintains the paper's §7 quick fix
  (:func:`~repro_torch.core.topology_finder.repair_topology`) as the static
  operator's incumbent.
* :func:`run_online` — an iteration-granularity driver: each training
  iteration's flows are regenerated from the *current* plan, a
  failure/load-shift trace is injected (at iteration boundaries or
  mid-iteration through the engine's failure events), and the policy decides
  between static repair and reactive replanning.
* :func:`place_arrival` — topology-aware placement of newly arriving jobs:
  pick the free servers with the most surviving pairwise capacity instead of
  the lowest ids.

Multi-tenant shared fabrics: :class:`JobSetController` holds the resident
:class:`~repro_torch.core.workloads.JobSet` instead of a single job — it
re-optimizes the *union* demand via
:func:`~repro_torch.core.alternating.co_optimize_jobset` on arrival / departure /
failure, admits arrivals through :func:`place_arrival`, and probes with
per-tenant flow graphs under the set's weighted fairness.
:func:`run_online_jobset` drives a churn trace (jobs arriving, departing,
fibers dying) against it.

Placement as a co-optimization axis: on a shared fabric the fourth coupled
dimension is *where each tenant sits*.  :func:`place_candidates` generates
diverse candidate server sets for an arrival (greedy-capacity seed first,
then contiguous / spread / anti-affinity variants);
``JobSetController.admit(candidates=k)`` — or ``ReoptPolicy.candidates`` —
threads them through the replan, which scores every candidate with the
full alternating loop and adopts the best *plan including placement*
(``candidates=1`` is byte-identical to the greedy-then-replan path).  After
a departure, :meth:`JobSetController.rebalance` proposes migrating up to
``ReoptPolicy.max_migrations`` resident tenants into the freed capacity,
each move priced by :func:`repro_torch.core.costmodel.migration_cost`
(checkpoint-restore seconds + churn-priced fiber moves) and adopted only
when the probed amortized win clears the price;
:class:`~repro_torch.core.simengine.MigrationRecord`\\ s land in run results and
``ScenarioResult.migrations``.

**Backends.**  The replan optimizer runs where ``ReoptPolicy.backend`` and
``ReoptPolicy.device`` say: ``"torch"`` (the default) plans on ``device``,
the card when ``None`` — and a replan without a card raises rather than
planning on the CPU; ``device="cpu"`` runs the same chains on the CPU.
``"numpy"`` is the host MCMC walk, equal to the JAX package's default
backend to the bit.  ``"jax"`` is refused.  The fluid simulations (probes
and the drivers' iterations, :meth:`SimEngine.run`) are host NumPy on every
backend: each :class:`SimEngine` built here is given the policy's backend
and device, but only :meth:`SimEngine.comm_time` reaches the device, and
nothing here calls it.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from ..compat import resolve_device
from .alternating import (
    CoOptResult,
    JobSetPlan,
    alternating_optimize,
    co_optimize_jobset,
)
from .costmodel import MIGRATION_RESTART_S, migration_cost
from .demand import remap_demand
from .netsim import HardwareSpec, compute_time
from .ocs_reconfig import _RECONFIG_LATENCY as RECONFIG_LATENCY
from .planeval import JobSetEvaluator
from .simengine import (
    DeadlineFairness,
    EngineView,
    FairnessPolicy,
    LinkFailure,
    MigrationRecord,
    PlanUpdate,
    Scenario,
    ScenarioObserver,
    SimEngine,
    SimJob,
    WeightedFairness,
    iteration_tasks,
    links_from_topology,
)
from .strategy_search import Strategy, default_strategy
from .topology_finder import Topology, remove_pair, restore_pair
from .workloads import JobSet, JobSpec, TenantJob

__all__ = [
    "ReoptPolicy",
    "ReoptController",
    "JobSetController",
    "TraceEvent",
    "OnlineRunResult",
    "JobSetRunResult",
    "run_online",
    "run_online_jobset",
    "place_arrival",
    "place_candidates",
    "edge_churn",
]


def edge_churn(old: Topology, new: Topology) -> int:
    """Fibers the patch panel must re-seat to turn ``old`` into ``new``:
    the directed-edge multiset difference (each graph edge is one physical
    port-to-port fiber; edges present in both plans stay patched)."""
    c_old = Counter(old.graph.edges())
    c_new = Counter(new.graph.edges())
    return int(sum((c_new - c_old).values()))


@dataclass(frozen=True)
class ReoptPolicy:
    """Trigger rules for online re-optimization.

    Any combination of triggers may be enabled:

    * ``on_failure`` — replan when a fiber pair dies.
    * ``on_arrival`` / ``on_departure`` — replan on load shifts (a job
      joining or leaving the fabric, or :func:`run_online` swapping the
      resident job's spec).
    * ``period`` — unconditional periodic replanning every ``period`` s.
    * ``degradation_threshold`` + ``check_interval`` — every
      ``check_interval`` s, estimate the incumbent's fluid iteration time on
      the (repaired) surviving fabric; replan when it exceeds
      ``degradation_threshold`` x the baseline recorded at plan adoption.

    ``min_interval`` is hysteresis: replans closer than this to the previous
    one are suppressed (failed triggers leave the static repair in place).
    Every applied replan charges ``replan_latency`` seconds of OCS-style
    traffic pause.

    Churn-proportional cost (``fiber_move_latency``): real patch panels
    charge per *moved fiber*, not a flat fee.  When set, an adopted replan's
    pause is ``fiber_move_latency * edges_moved`` (the directed-edge diff
    between incumbent and replanned topology, :func:`edge_churn`) and a
    replan that keeps the incumbent pauses nothing; ``None`` keeps the flat
    ``replan_latency`` (the pre-churn behaviour).  Constants to plug in live
    in :mod:`repro_torch.core.costmodel` (``FIBER_MOVE_S``, ``OCS_FIBER_MOVE_S``).

    Adaptive hysteresis (``adaptive``): a triggered replan is *skipped* —
    no pause, no fabric change — when the probed marginal win over the
    degraded incumbent, amortized over ``payback_horizon`` iterations, is
    below its (churn-proportional) pause cost; each skip doubles the
    controller's effective ``min_interval`` (reset on the next adopted
    replan), so hopeless replanning backs off instead of burning pauses.

    ``probe_slack`` tunes the incremental degradation probe: after a full
    one-iteration flow probe the controller caches the estimate together
    with the link set whose planned utilization exceeds ``probe_slack`` x
    the bottleneck; later probes reuse the cached estimate until a failure
    touches that hot set (or the demand changes).  ``0.0`` = every loaded
    link is hot (reuse only across failures of unloaded pairs);
    ``~0.95`` = only near-bottleneck links invalidate.
    """

    on_failure: bool = True
    on_arrival: bool = False
    on_departure: bool = False
    period: float | None = None
    check_interval: float | None = None
    degradation_threshold: float | None = None
    min_interval: float = 0.0
    replan_latency: float = RECONFIG_LATENCY
    # Churn-proportional replan cost: seconds per moved fiber (None = flat).
    fiber_move_latency: float | None = None
    # Benefit-vs-cost replan gate + min_interval backoff.
    adaptive: bool = False
    payback_horizon: float = 8.0  # iterations a replan must amortize over
    # Incremental probe: bottleneck-set utilization threshold in [0, 1).
    probe_slack: float = 0.0
    # Placement co-search: candidate placements tried per admission
    # (:func:`place_candidates`); 1 = the greedy `place_arrival` path,
    # byte-identical to the pre-search behaviour.
    candidates: int = 1
    # Churn-priced tenant migration: how many resident tenants one
    # :meth:`JobSetController.rebalance` call may move (0 disables — no
    # rebalance ever runs, the pre-migration behaviour).  An adopted move
    # must clear its checkpoint-restore + fiber-churn cost
    # (:func:`repro_torch.core.costmodel.migration_cost`) amortized over
    # ``payback_horizon`` iterations.
    max_migrations: int = 0
    # Per-migration drain/teardown/re-init floor in seconds (the
    # checkpoint-transfer and fiber components are priced per tenant and
    # per moved fiber on top of this).  Defaults to the cost model's
    # documented floor; simulations on sub-second iteration timescales
    # lower it explicitly (as the placement benchmark does).
    migration_restart: float = MIGRATION_RESTART_S
    # Warm-started optimizer budget per replan (smaller than offline: the
    # incumbent is already good, we only adapt it).
    rounds: int = 2
    mcmc_iters: int = 40
    # Candidate pricing inside the replan optimizer: the compiled plan
    # evaluator (repro_torch.core.planeval) by default; False pins the reference
    # topoopt_comm_time path (fixed seeds must agree between the two).
    compiled: bool = True
    # Planner backend of the replan optimizer's inner MCMC: "torch" (the
    # default) runs ``chains`` batched annealing chains per round on
    # ``device`` (repro_torch.core.planeval_torch); "numpy" is the host walk,
    # equal to the JAX package's default backend to the bit.
    backend: str = "torch"
    chains: int = 1
    # Multi-tenant annealing objective: "decomposed" prices each tenant's
    # own weighted-share comm time instead of charging everyone the union
    # bottleneck (see mcmc_search_jobset).  Default preserves goldens.
    objective: str = "union"
    # Admission-time preemption: an *arriving* tenant triggers the same
    # churn-priced rebalance pass a departure does (max_migrations > 0
    # required), displacing cheap residents when the migration-priced win
    # clears its cost.  Off by default — the pre-fix behaviour, where only
    # departures could rebalance.
    rebalance_on_arrival: bool = False
    # Pre-screen wide placement-candidate lists inside co_optimize_jobset:
    # only the k best candidates by the incremental evaluator pay the full
    # alternating loop (None = screen nothing, the pre-fix behaviour).
    screen_candidates: int | None = None
    # Collective-schedule search axis of the replan optimizer's inner MCMC
    # (repro_torch.core.schedules): a tuple of schedule names the proposal kernel
    # may flip per AllReduce-bearing strategy, e.g. ("ring",
    # "recursive_hd", "multi_tree").  None / ("ring",) keeps the search
    # (and its RNG streams) byte-identical to the pre-schedule behaviour.
    schedules: tuple[str, ...] | None = None
    # Parallel-tempering ladder of the grid chain program (ascending
    # floats).  With backend="torch" and placement candidates this turns
    # every admission into the *fused* co-search: all screened candidates x
    # the ladder anneal in one grid program per alternating round
    # (repro_torch.core.alternating._co_optimize_fused).  None keeps the flat
    # single-temperature chains; requires backend="torch" when set.
    temperatures: tuple[float, ...] | None = None
    # -- robustness hardening (fault storms) --------------------------------
    # Wall-clock budget in seconds for one warm optimizer run inside a
    # replan.  The optimizer is not interruptible, so the deadline is
    # checked post-hoc: an over-budget run is discarded and retried with a
    # bumped seed (the last permitted attempt's result is kept either way
    # rather than thrown away).  None disables the deadline.
    replan_deadline: float | None = None
    # Seed-bumped retries after an optimizer raise or deadline overrun
    # before the controller gives up on this trigger and keeps the
    # last-known-good plan (+ §7 repair).  Exhausting every attempt arms an
    # exponential backoff — base ``retry_backoff`` seconds (None: the max
    # of ``replan_latency``/``min_interval``/1 ms), doubling per
    # consecutive exhaustion — so a fault storm cannot wedge the controller
    # in a replan-crash loop.
    replan_retries: int = 2
    retry_backoff: float | None = None
    # Validate every candidate plan before adoption: per-node degree
    # budgets, no edge on a dead pair, per-node capacity conservation, and
    # tenant-ring connectivity on the *live* degraded fabric.  A plan that
    # fails a check the incumbent passes is rejected in favour of the
    # last-known-good plan + §7 repair.  Valid plans (everything a healthy
    # optimizer emits) adopt byte-identically to the unvalidated path.
    validate_plans: bool = True
    # Where backend="torch" plans (and what every SimEngine built here is
    # given): None is the card, which raises without one; "cpu" runs the
    # same chains on the host.
    device: str | None = None

    def __post_init__(self):
        if self.backend not in ("numpy", "torch"):
            raise ValueError(
                f"unknown ReoptPolicy backend {self.backend!r} (use 'torch', "
                "the default, or 'numpy')"
            )
        if self.temperatures is not None and self.backend != "torch":
            raise ValueError(
                "temperatures (tempering ladder) needs backend='torch'"
            )

    @classmethod
    def never(cls) -> "ReoptPolicy":
        """Static plan: no trigger ever fires (the plain engine's
        semantics)."""
        return cls(on_failure=False, replan_latency=0.0)

    @classmethod
    def reactive(cls, min_interval: float = 0.0, **kw) -> "ReoptPolicy":
        """Replan on every failure and load shift (subject to hysteresis)."""
        return cls(on_failure=True, on_arrival=True, on_departure=True,
                   min_interval=min_interval, **kw)

    @classmethod
    def periodic(cls, period: float, **kw) -> "ReoptPolicy":
        return cls(on_failure=False, period=period, **kw)

    @classmethod
    def degradation(
        cls, threshold: float, check_interval: float, **kw
    ) -> "ReoptPolicy":
        return cls(on_failure=False, degradation_threshold=threshold,
                   check_interval=check_interval, **kw)

    @property
    def check_period(self) -> float | None:
        """Interval between observer checks, if any trigger needs them."""
        if self.period is not None:
            return self.period
        if (
            self.check_interval is not None
            and self.degradation_threshold is not None
        ):
            return self.check_interval
        return None


@dataclass
class ReplanRecord:
    """One controller decision, for logs and benchmarks."""

    time: float
    trigger: str  # "failure" | "arrival" | "departure" | "periodic" | ...
    replanned: bool
    est_before: float = float("nan")  # incumbent (repaired) iteration time
    est_after: float = float("nan")  # adopted plan's iteration time
    edges_moved: int = 0  # physical fiber churn of the adopted swap


class ReoptController(ScenarioObserver):
    """Couples :func:`alternating_optimize` into a running scenario.

    The controller tracks three things across events:

    * ``dead`` — fiber pairs that failed so far; every replanned topology is
      searched with these pairs ``forbidden``.
    * the **incumbent plan** (``plan``/``topology``/``demand``) — after a
      failure with no replan trigger, the incumbent topology is degraded in
      place (:func:`~repro_torch.core.topology_finder.remove_pair`: dead pair
      gone, routes re-pathed over the survivors) — the plan a static
      operator keeps running; after a replan it is the freshly optimized
      plan, warm-started from the old one.
    * ``baseline`` — the one-iteration simulated makespan recorded when the
      incumbent was adopted, against which the degradation trigger compares.

    As a :class:`ScenarioObserver` it turns replans into
    :class:`PlanUpdate`s: new fabric links + a ``replan_latency`` pause, so
    in-flight flows resume (bytes preserved) on the new topology mid-run.
    A controller whose policy never triggers returns ``None`` from every
    hook, leaving the engine bit-identical to an observer-less run.
    """

    def __init__(
        self,
        job: JobSpec | None,
        n: int,
        hw: HardwareSpec | None = None,
        policy: ReoptPolicy | None = None,
        seed: int = 0,
        plan: CoOptResult | None = None,
    ):
        self.job = job
        self.n = n
        self.hw = hw or HardwareSpec()
        self.policy = policy or ReoptPolicy()
        self.seed = seed
        self.dead: set[tuple[int, int]] = set()
        self.n_replans = 0
        self.total_edges_moved = 0
        # Hardened replan path: retry nonce folded into the warm seed (0 on
        # first attempts — byte-identical to the pre-hardening seeds),
        # consecutive give-ups, and the backoff gate they arm.
        self._retry_nonce = 0
        self._replan_failures = 0
        self._backoff_until = -np.inf
        self.n_rejected_plans = 0  # plans refused by validation
        self.n_optimizer_errors = 0  # raises + deadline overruns survived
        # pair -> graph edges _note_dead removed, so repair() can restore
        # the incumbent fabric in place.
        self._cut_edges: dict[tuple[int, int], list] = {}
        # Pause of the most recent *applied* PlanUpdate (drivers charge the
        # tail of a pause that hangs past the last task finish).
        self.last_pause = 0.0
        self.last_replan = -np.inf
        self.log: list[ReplanRecord] = []
        self._plan: CoOptResult | None = plan
        self._topology: Topology | None = plan.topology if plan else None
        self._baseline: float | None = None
        self._probe_engine: SimEngine | None = None
        # Incremental degradation probe: (estimate, hot undirected pairs)
        # from the last full flow probe of the incumbent; reused until a
        # failure touches the hot set or the demand changes.
        self._probe_cache: tuple[float, frozenset] | None = None
        self.n_full_probes = 0
        # Adaptive hysteresis: effective min_interval, doubled per skipped
        # (benefit < cost) replan, reset on adoption.
        self._adaptive_interval = self.policy.min_interval
        # Global-clock time of the replan currently being computed; hooks
        # that need "now" inside _run_optimizer (deadline urgency) read it.
        self._replan_now = 0.0
        # Hook clock = engine-local time + clock_offset.  Drivers that run a
        # sequence of scenarios (run_online: one per training iteration) set
        # the offset so hysteresis spans scenario boundaries.
        self.clock_offset = 0.0
        # run_online admits one SimJob per iteration; those admissions are
        # not load shifts, so the driver mutes the arrival/departure hooks
        # and feeds genuine load shifts through set_job instead.
        self.suppress_job_hooks = False
        interval = self.policy.check_period
        # Global-clock time of the next periodic/degradation check.
        self._next_check_global = interval if interval is not None else np.inf

    # -- incumbent plan ------------------------------------------------------

    def _run_optimizer(self, warm: bool) -> CoOptResult:
        """One optimizer run against the current resident workload.
        Subclasses (:class:`JobSetController`) override this to optimize
        their own notion of "the resident job"."""
        if not warm:
            return alternating_optimize(
                self.job, self.n, self.hw,
                rounds=max(self.policy.rounds, 2),
                mcmc_iters=max(self.policy.mcmc_iters, 40),
                seed=self.seed,
                forbidden=tuple(self.dead),
                compiled=self.policy.compiled,
                backend=self.policy.backend,
                chains=self.policy.chains,
                schedules=self.policy.schedules,
                temperatures=self.policy.temperatures,
                device=self.policy.device,
            )
        return alternating_optimize(
            self.job, self.n, self.hw,
            rounds=self.policy.rounds,
            mcmc_iters=self.policy.mcmc_iters,
            seed=self.seed + 1 + self.n_replans + 997 * self._retry_nonce,
            warm_topology=self.topology,
            warm_strategy=self.strategy,
            forbidden=tuple(self.dead),
            compiled=self.policy.compiled,
            backend=self.policy.backend,
            chains=self.policy.chains,
            schedules=self.policy.schedules,
            temperatures=self.policy.temperatures,
            device=self.policy.device,
        )

    def ensure_plan(self) -> CoOptResult:
        """Cold-start the offline optimizer once, lazily (a controller whose
        policy never fires should cost nothing)."""
        if self._plan is None:
            self._plan = self._run_optimizer(warm=False)
            self._topology = self._plan.topology
        return self._plan

    @property
    def plan(self) -> CoOptResult:
        return self.ensure_plan()

    @property
    def topology(self) -> Topology:
        """The live physical plan: replanned, or incumbent + §7 repairs."""
        self.ensure_plan()
        assert self._topology is not None
        return self._topology

    @property
    def strategy(self) -> Strategy:
        return self.plan.strategy

    @property
    def demand(self):
        return self.strategy.demand(self.job, self.n)

    @property
    def baseline(self) -> float:
        """Iteration-time estimate the degradation trigger compares against.

        Established on first access (and re-pinned by every replan) — read it
        once while the fabric is still healthy when using the degradation
        trigger; :func:`run_online` does this before applying any trace."""
        if self._baseline is None:
            self.ensure_plan()
            self._baseline = self.estimated_iter_time()
        return self._baseline

    def links(self) -> dict[tuple[int, int], float]:
        """Directed link capacities of the current topology on the surviving
        fabric (dead pairs carry nothing, whatever the plan says)."""
        return self._links_for(self.topology)

    def _links_for(self, topo: Topology) -> dict[tuple[int, int], float]:
        caps = links_from_topology(topo, self.hw)
        for a, b in list(caps):
            if (min(a, b), max(a, b)) in self.dead:
                del caps[(a, b)]
        return caps

    def _probe_jobs(self, topo: Topology, strategy) -> list[SimJob]:
        """The one-iteration flow graph(s) the probe simulates; subclasses
        build one SimJob per tenant."""
        demand = strategy.demand(self.job, self.n)
        comp = compute_time(
            self.job.flops_per_sample * self.job.batch_per_gpu * self.n,
            self.n, self.hw,
        )
        return [SimJob("probe", iteration_tasks(topo, demand,
                                                compute_duration=comp))]

    def _probe_fairness(self) -> FairnessPolicy | None:
        return None

    def _probe_metric(self, res) -> float:
        """Scalar the probe optimizes for; subclasses weight per-job times."""
        return res.makespan

    def _hot_pairs(
        self, jobs: list[SimJob], links: dict[tuple[int, int], float]
    ) -> frozenset | None:
        """Undirected pairs whose planned utilization exceeds
        ``probe_slack`` x the bottleneck; failures outside this set cannot
        move the cached estimate.  Returns ``None`` — *every* failure
        invalidates — when any planned hop has no live link: the engine
        detours such flows over links the plan never names, so the hot set
        cannot be known from the plan alone."""
        # Vectorized hop accounting: encode every planned hop as a dense
        # pair id, sum bytes with one bincount, and look capacities up only
        # for the unique loaded links.
        hop_a: list[np.ndarray] = []
        hop_b: list[np.ndarray] = []
        hop_bytes: list[np.ndarray] = []
        for j in jobs:
            for t in j.tasks:
                if t.kind != "flow" or len(t.route) < 2:
                    continue
                r = np.asarray(t.route, dtype=np.int64)
                hop_a.append(r[:-1])
                hop_b.append(r[1:])
                hop_bytes.append(np.full(r.size - 1, t.nbytes))
        if not hop_a:
            return frozenset()
        a = np.concatenate(hop_a)
        b = np.concatenate(hop_b)
        ids = a * self.n + b
        uniq, inv = np.unique(ids, return_inverse=True)
        loads = np.bincount(inv, weights=np.concatenate(hop_bytes))
        pairs = [(int(i) // self.n, int(i) % self.n) for i in uniq]
        caps = np.asarray([links.get(p) or 0.0 for p in pairs])
        alive = caps > 0
        if np.any(~alive & (loads > 0)):
            return None  # detour-routed flow: hot set unknowable
        if not np.any(alive):
            return frozenset()
        util = np.zeros_like(loads)
        util[alive] = loads[alive] / caps[alive]
        thresh = self.policy.probe_slack * float(util.max())
        return frozenset(
            (min(p), max(p))
            for p, u, live in zip(pairs, util, alive)
            if live and u > thresh
        )

    def estimated_iter_time(
        self,
        topo: Topology | None = None,
        strategy=None,
    ) -> float:
        """One-iteration simulated makespan of ``strategy`` on ``topo``
        restricted to the surviving fabric (defaults: the incumbent).

        A flow-level probe rather than the fluid formula: the fluid model
        charges AllReduce rings by the *planned* ring edges, so it cannot see
        a dead ring link; the scenario engine re-routes those flows over the
        survivors and prices the resulting contention.

        Incumbent probes (both arguments defaulted) are cached together with
        the hot link set (:meth:`_hot_pairs`): failures that do not touch a
        hot link, and checks with no intervening change, reuse the cached
        estimate instead of re-simulating — the incremental probe that keeps
        shared multi-job scenarios cheap."""
        incumbent = topo is None and strategy is None
        if incumbent and self._probe_cache is not None:
            return self._probe_cache[0]
        topo = topo if topo is not None else self.topology
        strategy = strategy if strategy is not None else self.strategy
        jobs = self._probe_jobs(topo, strategy)
        links = self._links_for(topo)
        if self._probe_engine is None:
            self._probe_engine = SimEngine(
                self.hw, backend=self.policy.backend, device=self.policy.device
            )
        sc = Scenario(
            links=links, jobs=jobs, n=self.n, fairness=self._probe_fairness()
        )
        res = self._probe_engine.run(sc)
        self.n_full_probes += 1
        if res.stalled:
            # Unroutable demand stall-finishes instantly in the engine; a
            # disconnected fabric must probe as unusable, not as fast.
            est = float(np.inf)
        else:
            est = float(self._probe_metric(res))
        if incumbent:
            self._probe_cache = (est, self._hot_pairs(jobs, links))
        return est

    # -- mutations -----------------------------------------------------------

    def set_job(self, job: JobSpec, now: float = 0.0) -> float:
        """Load shift: the resident job's spec changes (new batch size, new
        tables, a different model).  Returns the pause charged (seconds) if
        the arrival trigger replanned."""
        self.job = job
        self._probe_cache = None  # demand changed: cached estimate is stale
        if self.policy.on_arrival:
            update = self._maybe_replan(now, "arrival")
            if update is not None:
                return update.pause
        return 0.0

    def _note_dead(self, pair: tuple[int, int]) -> None:
        """Record a dead pair and degrade the incumbent; the probe cache
        survives only when the pair is outside the cached hot link set
        (a ``None`` hot set means any failure invalidates)."""
        if self._probe_cache is not None and (
            self._probe_cache[1] is None or pair in self._probe_cache[1]
        ):
            self._probe_cache = None
        self.dead.add(pair)
        if self._topology is not None:
            # Snapshot what the cut takes out so a transient fault can be
            # healed in place (restore_pair) when the repair lands.
            g = self._topology.graph
            self._cut_edges[pair] = [
                (a, b, dict(data))
                for a, b in (pair, (pair[1], pair[0]))
                if g.has_edge(a, b)
                for data in g[a][b].values()
            ]
            self._topology = remove_pair(self._topology, pair)

    def _note_repaired(self, pair: tuple[int, int]) -> None:
        """A dead pair came back: lift the forbidden constraint, restore the
        incumbent's cut edges in place, and drop the probe cache (capacity
        improved, so any cached estimate is stale)."""
        self.dead.discard(pair)
        self._probe_cache = None
        edges = self._cut_edges.pop(pair, None)
        if edges and self._topology is not None:
            self._topology = restore_pair(self._topology, pair, edges)

    def fail(self, link: tuple[int, int], now: float = 0.0) -> float:
        """A node pair dies.  Always records the pair and degrades the
        incumbent (routes re-pathed over survivors); replans when the policy
        says so.  Returns the pause charged (seconds)."""
        pair = (min(link), max(link))
        if pair in self.dead:
            return 0.0
        self._note_dead(pair)
        if self.policy.on_failure:
            update = self._maybe_replan(now, "failure")
            if update is not None:
                return update.pause
        return 0.0

    def repair(self, link: tuple[int, int], now: float = 0.0) -> float:
        """A previously failed pair heals (transient fault over).  Always
        restores the incumbent's cut capacity; the failure trigger, if
        enabled, may additionally replan to reclaim the pair.  Returns the
        pause charged (seconds)."""
        pair = (min(link), max(link))
        if pair not in self.dead:
            return 0.0
        self._note_repaired(pair)
        if self.policy.on_failure:
            update = self._maybe_replan(now, "repair")
            if update is not None:
                return update.pause
        return 0.0

    def _replan_pause(self, edges_moved: int) -> float:
        """Churn-proportional pause when the policy prices per moved fiber,
        the flat ``replan_latency`` otherwise."""
        if self.policy.fiber_move_latency is not None:
            return self.policy.fiber_move_latency * edges_moved
        return self.policy.replan_latency

    def _adopt_plan(self, res) -> None:
        """Install ``res`` as the incumbent plan.  Subclasses extend this
        to sync plan provenance (an adopted candidate placement)."""
        self._plan = res
        self._topology = res.topology

    def _estimate_plan(self, res) -> float:
        """Probe a freshly optimized plan's one-iteration time.  Subclasses
        override to probe under the plan's own tenant placements."""
        return self.estimated_iter_time(
            topo=res.topology, strategy=res.strategy
        )

    def _retry_backoff_base(self) -> float:
        if self.policy.retry_backoff is not None:
            return self.policy.retry_backoff
        return max(self.policy.replan_latency, self.policy.min_interval, 1e-3)

    def _guarded_optimize(self, now: float, trigger: str):
        """Run the warm optimizer under the hardening policy: a post-hoc
        wall-clock deadline (``replan_deadline``) and bounded seed-bumped
        retries when it raises or overruns.  Returns the optimizer result,
        or ``None`` after exhausting every attempt — the caller then keeps
        the last-known-good plan (+ §7 repair) and the controller backs off
        exponentially, so a fault storm cannot wedge it in a replan-crash
        loop."""
        import time as _time

        if self.policy.backend == "torch":
            # Outside the retry guard: a missing card is no fault a retry
            # can fix, and the planner never falls back to the CPU.
            resolve_device(self.policy.device)
        deadline = self.policy.replan_deadline
        attempts = 1 + max(int(self.policy.replan_retries), 0)
        for attempt in range(attempts):
            self._retry_nonce = attempt
            t0 = _time.perf_counter()
            try:
                res = self._run_optimizer(warm=True)
            except Exception:
                self.n_optimizer_errors += 1
                self.log.append(ReplanRecord(
                    time=now, trigger=f"{trigger}:error", replanned=False))
                continue
            finally:
                self._retry_nonce = 0
            if (
                deadline is not None
                and _time.perf_counter() - t0 > deadline
                and attempt + 1 < attempts
            ):
                # Over budget with retry budget left: discard, try another
                # seed.  The last permitted attempt keeps its result —
                # better a late plan than none.
                self.n_optimizer_errors += 1
                self.log.append(ReplanRecord(
                    time=now, trigger=f"{trigger}:deadline", replanned=False))
                continue
            self._replan_failures = 0
            self._backoff_until = -np.inf
            return res
        self._replan_failures += 1
        self._backoff_until = now + self._retry_backoff_base() * (
            2 ** (self._replan_failures - 1)
        )
        self.last_replan = now
        return None

    def _required_groups(self) -> list[tuple[int, ...]]:
        """Server groups that must stay mutually reachable on the live
        fabric for the plan to be servable.  The single resident job spans
        every node; :class:`JobSetController` lists per-tenant placements."""
        return [tuple(range(self.n))] if self.job is not None else []

    def plan_violations(self, topo: Topology) -> list[str]:
        """Validate a candidate topology against the live degraded fabric.

        Checks: per-node degree budgets (with the +1 slack §7 repair
        donations get), no edge on a dead pair, per-node capacity
        conservation, and required-group connectivity on the surviving
        links.  Returns human-readable violations; empty means valid."""
        out: list[str] = []
        budget = topo.degree + 1
        outdeg = Counter(a for a, _ in topo.graph.edges())
        indeg = Counter(b for _, b in topo.graph.edges())
        worst_out = max(outdeg.values(), default=0)
        worst_in = max(indeg.values(), default=0)
        if worst_out > budget or worst_in > budget:
            out.append(
                f"degree budget exceeded: out={worst_out}/in={worst_in} "
                f"> {budget}"
            )
        on_dead = sorted({
            (min(a, b), max(a, b))
            for a, b in topo.graph.edges()
            if (min(a, b), max(a, b)) in self.dead
        })
        if on_dead:
            out.append(f"edges on dead pairs {on_dead[:4]}")
        links = self._links_for(topo)
        cap_budget = budget * self.hw.link_bandwidth * (1.0 + 1e-9)
        node_cap: dict[int, float] = {}
        for (a, _b), c in links.items():
            node_cap[a] = node_cap.get(a, 0.0) + c
        worst_cap = max(node_cap.values(), default=0.0)
        if worst_cap > cap_budget:
            out.append(
                f"capacity conservation violated: {worst_cap:.3g} B/s out "
                f"of one node > {cap_budget:.3g}"
            )
        groups = [g for g in self._required_groups() if len(g) > 1]
        if groups:
            import networkx as nx

            g = nx.DiGraph()
            g.add_nodes_from(range(self.n))
            g.add_edges_from(links.keys())
            comp_of: dict[int, int] = {}
            for ci, comp in enumerate(nx.strongly_connected_components(g)):
                for v in comp:
                    comp_of[v] = ci
            for grp in groups:
                if len({comp_of[v] for v in grp}) > 1:
                    out.append(
                        f"servers {tuple(grp)[:6]} split across fabric "
                        "partitions"
                    )
        return out

    def replan(self, now: float, trigger: str) -> PlanUpdate | None:
        """Re-run the alternating optimizer warm-started from the incumbent,
        forbidding dead pairs; adopt whichever of {new plan, degraded
        incumbent} probes faster.  Returns the PlanUpdate to apply — or
        ``None`` when the adaptive gate skips (the probed win would not pay
        for the churn-proportional pause), the optimizer kept failing
        (:meth:`_guarded_optimize`), or validation rejected the candidate
        (:meth:`plan_violations`) — in the latter two cases the
        last-known-good plan + §7 repair stays in force."""
        self._replan_now = now
        self.ensure_plan()
        est_before = self.estimated_iter_time()
        res = self._guarded_optimize(now, trigger)
        if res is None:
            return None
        est_new = self._estimate_plan(res)
        if self.policy.validate_plans and est_new <= est_before:
            # About to adopt: validate first.  A candidate that probes well
            # but breaks a fabric invariant (degree budget, dead-pair edge,
            # capacity conservation, tenant-ring connectivity) is refused
            # and the last-known-good incumbent + §7 repair stays in force.
            # (When the *incumbent* fails the same checks — e.g. the fabric
            # is genuinely partitioned — the est comparison decides, as
            # before.)  Candidates the est comparison would reject anyway
            # take the unvalidated keep-incumbent path below, unchanged.
            bad = self.plan_violations(res.topology)
            if bad and not self.plan_violations(self.topology):
                self.n_rejected_plans += 1
                self.last_replan = now
                self.log.append(ReplanRecord(
                    time=now, trigger=f"{trigger}:invalid", replanned=False,
                    est_before=est_before, est_after=est_new,
                ))
                return None
        adopt = est_new <= est_before
        edges_moved = edge_churn(self.topology, res.topology) if adopt else 0
        pause = self._replan_pause(edges_moved)
        if adopt and self.policy.adaptive:
            benefit = (est_before - est_new) * self.policy.payback_horizon
            if not np.isfinite(est_before):
                benefit = np.inf if np.isfinite(est_new) else 0.0
            if benefit < pause:
                # Skip: the win doesn't pay for the fiber moves.  No pause,
                # no fabric change; back off the effective min_interval so
                # hopeless triggers stop re-running the optimizer.
                self.last_replan = now
                self._adaptive_interval = max(
                    2 * self._adaptive_interval, pause, self.policy.min_interval
                )
                self.log.append(ReplanRecord(
                    time=now, trigger=trigger, replanned=False,
                    est_before=est_before, est_after=est_new,
                ))
                return None
        if adopt:
            self._adopt_plan(res)
            self._baseline = est_new
            self._probe_cache = None
            self._adaptive_interval = self.policy.min_interval
        else:
            # The warm search couldn't beat the degraded incumbent — keep it
            # (still counts as a replan: the pause was spent deciding) and
            # re-baseline so the degradation trigger doesn't fire forever.
            self._baseline = est_before
        self.n_replans += 1
        self.total_edges_moved += edges_moved
        self.last_replan = now
        self.last_pause = pause
        self.log.append(ReplanRecord(
            time=now, trigger=trigger, replanned=True,
            est_before=est_before, est_after=min(est_new, est_before),
            edges_moved=edges_moved,
        ))
        return PlanUpdate(
            links=self.links(),
            pause=pause,
            label=f"reopt:{trigger}",
            edges_moved=edges_moved,
        )

    def _maybe_replan(self, now: float, trigger: str) -> PlanUpdate | None:
        if now < self._backoff_until:
            # Optimizer-failure backoff: a storm of triggers while replans
            # keep raising/overrunning must not re-run the optimizer on
            # every event.
            self.log.append(ReplanRecord(
                time=now, trigger=f"{trigger}:backoff", replanned=False))
            return None
        gate = (
            self._adaptive_interval if self.policy.adaptive
            else self.policy.min_interval
        )
        if now - self.last_replan < gate:
            self.log.append(ReplanRecord(time=now, trigger=trigger,
                                         replanned=False))
            return None
        return self.replan(now, trigger)

    # -- ScenarioObserver hooks ---------------------------------------------

    def next_check(self, now: float) -> float:
        # The engine speaks scenario-local time; the schedule is global.
        return self._next_check_global - self.clock_offset

    def on_failure(
        self, view: EngineView, link: tuple[int, int]
    ) -> PlanUpdate | None:
        pair = (min(link), max(link))
        if pair in self.dead:
            return None
        self._note_dead(pair)
        if not self.policy.on_failure:
            return None
        return self._maybe_replan(view.now + self.clock_offset, "failure")

    def on_repair(
        self, view: EngineView, link: tuple[int, int]
    ) -> PlanUpdate | None:
        pair = (min(link), max(link))
        if pair not in self.dead:
            return None
        self._note_repaired(pair)
        if not self.policy.on_failure:
            # Static operator: the engine already restored the capacity;
            # the healed incumbent simply resumes.
            return None
        return self._maybe_replan(view.now + self.clock_offset, "repair")

    def on_arrival(self, view: EngineView, job: SimJob) -> PlanUpdate | None:
        if not self.policy.on_arrival or self.suppress_job_hooks:
            return None
        return self._maybe_replan(view.now + self.clock_offset, "arrival")

    def on_departure(self, view: EngineView, job_name: str) -> PlanUpdate | None:
        if not self.policy.on_departure or self.suppress_job_hooks:
            return None
        return self._maybe_replan(view.now + self.clock_offset, "departure")

    def on_check(self, view: EngineView) -> PlanUpdate | None:
        interval = self.policy.check_period
        if interval is None:
            return None
        now = view.now + self.clock_offset
        self._next_check_global = now + interval
        if self.policy.period is not None:
            return self._maybe_replan(now, "periodic")
        # Degradation probe: estimated iteration time on the degraded
        # incumbent vs the baseline recorded at adoption.
        est = self.estimated_iter_time()
        if est > self.policy.degradation_threshold * self.baseline:
            return self._maybe_replan(now, "degradation")
        self.log.append(ReplanRecord(time=now, trigger="check",
                                     replanned=False, est_before=est))
        return None


# ---------------------------------------------------------------------------
# Multi-tenant controller: the resident workload is a JobSet
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _UrgencyWeightedFairness(FairnessPolicy):
    """Static per-tenant weights scaled by deadline urgency — the engine
    analogue of :meth:`JobSetController._opt_jobset`'s ``weight * urgency``
    replan objective, re-queried each rate recomputation as the clock
    approaches deadlines."""

    time_varying = True

    weights: dict[str, float] = field(default_factory=dict)
    deadline: DeadlineFairness = field(default_factory=DeadlineFairness)

    def weight(self, job: str, now: float) -> float:
        return self.weights.get(job, 1.0) * self.deadline.weight(job, now)


class JobSetController(ReoptController):
    """A :class:`ReoptController` whose resident workload is a whole
    :class:`~repro_torch.core.workloads.JobSet` sharing one fabric.

    Replans re-optimize the *union* demand
    (:func:`~repro_torch.core.alternating.co_optimize_jobset`, warm-started from
    the incumbent shared plan, dead pairs forbidden); probes simulate one
    iteration of every tenant contending under the set's weighted fairness;
    :meth:`admit` places arrivals on the surviving fabric via
    :func:`place_arrival` and :meth:`depart` frees a tenant's servers — both
    are load shifts the policy's arrival/departure triggers may answer with
    a replan.  Tenants admitted without a replan ride the incumbent fabric:
    their AllReduce bytes take a synthetic ring over their placement
    (``iteration_tasks(synth_missing_rings=True)``) until the next replan
    gives them real rings.
    """

    def __init__(
        self,
        jobset: JobSet,
        hw: HardwareSpec | None = None,
        policy: ReoptPolicy | None = None,
        seed: int = 0,
        plan: JobSetPlan | None = None,
        deadline_policy: DeadlineFairness | None = None,
    ):
        self.jobset = jobset
        # Deadline-aware replanning: when set, every replan's objective
        # weights each tenant by ``weight * deadline_policy.weight(label,
        # now)`` so a near-deadline tenant's traffic dominates the union
        # objective, and the engine runs the same policy as its bandwidth
        # fairness.  ``None`` keeps the static weighted objective.
        self.deadline_policy = deadline_policy
        # Candidate JobSets (greedy seed first) a replan should co-search;
        # set by :meth:`admit` around its _maybe_replan call.
        self._pending_candidates: list[JobSet] | None = None
        # Every migration decision rebalance() ever took (adopted or not).
        self.migrations: list[MigrationRecord] = []
        # Arrivals admit() turned away because no live fabric component
        # could host them: (time, label) records, in admission order.
        self.refused: list[tuple[float, str]] = []
        super().__init__(job=None, n=jobset.n, hw=hw, policy=policy,
                         seed=seed, plan=plan)

    # -- plan machinery ------------------------------------------------------

    def _opt_jobset(self, jobset: JobSet, now: float) -> JobSet:
        """The JobSet the optimizer should price: tenant weights scaled by
        deadline urgency at ``now`` (identity without a deadline policy)."""
        if self.deadline_policy is None:
            return jobset
        from dataclasses import replace as _replace

        return JobSet(n=jobset.n, tenants=[
            _replace(
                t,
                weight=t.weight * self.deadline_policy.weight(t.label, now),
            )
            for t in jobset.tenants
        ])

    def _run_optimizer(self, warm: bool) -> JobSetPlan:
        now = self._replan_now
        if not warm:
            return co_optimize_jobset(
                self._opt_jobset(self.jobset, now), self.hw,
                rounds=max(self.policy.rounds, 2),
                mcmc_iters=max(self.policy.mcmc_iters, 40),
                seed=self.seed,
                forbidden=tuple(self.dead),
                compiled=self.policy.compiled,
                objective=self.policy.objective,
                backend=self.policy.backend,
                chains=self.policy.chains,
                schedules=self.policy.schedules,
                temperatures=self.policy.temperatures,
                device=self.policy.device,
            )
        candidates = None
        if self._pending_candidates is not None:
            candidates = [
                self._opt_jobset(js, now) for js in self._pending_candidates
            ]
        return co_optimize_jobset(
            self._opt_jobset(self.jobset, now), self.hw,
            rounds=self.policy.rounds,
            mcmc_iters=self.policy.mcmc_iters,
            seed=self.seed + 1 + self.n_replans + 997 * self._retry_nonce,
            warm_topology=self.topology,
            warm_strategies=self.strategies(),
            forbidden=tuple(self.dead),
            compiled=self.policy.compiled,
            placement_candidates=candidates,
            screen_candidates=self.policy.screen_candidates,
            objective=self.policy.objective,
            backend=self.policy.backend,
            chains=self.policy.chains,
            schedules=self.policy.schedules,
            temperatures=self.policy.temperatures,
            device=self.policy.device,
        )

    def _adopt_plan(self, res) -> None:
        super()._adopt_plan(res)
        if self._pending_candidates is not None:
            # Sync the resident set to the winning candidate placement
            # (the *unscaled* JobSet — plan.jobset may carry urgency-scaled
            # weights).
            self.jobset = self._pending_candidates[res.candidate_index]
            self._probe_cache = None

    def _estimate_plan(self, res) -> float:
        if self._pending_candidates is None:
            return super()._estimate_plan(res)
        # Probe under the candidate's placements: the plan's flows live on
        # the candidate servers, not the incumbent greedy ones.
        saved = self.jobset
        self.jobset = self._pending_candidates[res.candidate_index]
        try:
            return self.estimated_iter_time(
                topo=res.topology, strategy=res.strategy
            )
        finally:
            self.jobset = saved

    def _maybe_replan(self, now: float, trigger: str) -> PlanUpdate | None:
        if not self.jobset.tenants:
            return None  # nothing to optimize for (e.g. failure after the
            # last tenant departed); keep the incumbent fabric as-is.
        return super()._maybe_replan(now, trigger)

    def _required_groups(self) -> list[tuple[int, ...]]:
        """Each multi-server tenant's ring must stay connected on the live
        fabric (single-server tenants have no network demand)."""
        return [t.servers for t in self.jobset.tenants if t.k > 1]

    def strategies(self) -> dict[str, Strategy]:
        """Per-tenant strategies of the incumbent plan, with cold defaults
        for tenants admitted after it was computed."""
        planned = dict(self.plan.strategies)
        return {
            t.label: planned.get(t.label) or default_strategy(t.spec)
            for t in self.jobset.tenants
        }

    @property
    def demand(self):
        """Cluster-level union demand of the resident set under the
        incumbent (default-extended) strategies."""
        return self.jobset.union_for(self.strategies())

    # -- probes --------------------------------------------------------------

    def _probe_jobs(self, topo: Topology, strategy) -> list[SimJob]:
        strategies = dict(strategy) if strategy else {}
        for t in self.jobset.tenants:
            strategies.setdefault(t.label, default_strategy(t.spec))
        jobs = []
        for t in self.jobset.tenants:
            dem = remap_demand(
                strategies[t.label].demand(t.spec, t.k), t.servers, self.n
            )
            comp = compute_time(t.flops_per_iteration, t.k, self.hw)
            jobs.append(SimJob(t.label, iteration_tasks(
                topo, dem, compute_duration=comp, synth_missing_rings=True,
            )))
        return jobs

    def _probe_fairness(self) -> FairnessPolicy | None:
        return self.fairness()

    def _probe_metric(self, res) -> float:
        """Weighted mean of per-job one-iteration makespans."""
        total = self.jobset.total_weight
        return sum(
            t.weight * res.job_makespans.get(t.label, 0.0)
            for t in self.jobset.tenants
        ) / total

    def iteration_jobs(self) -> list[SimJob]:
        """One SimJob per resident tenant (flows + compute) for the current
        plan — what :func:`run_online_jobset` feeds the engine each
        iteration."""
        return self._probe_jobs(self.topology, self.strategies())

    def fairness(self) -> FairnessPolicy:
        """The engine-side bandwidth policy: static tenant weights, scaled
        by deadline urgency when a deadline policy is set — the same
        ``weight * urgency`` product the replan objective prices
        (:meth:`_opt_jobset`), so simulated shares and the optimizer's view
        stay consistent."""
        if self.deadline_policy is not None:
            return _UrgencyWeightedFairness(
                weights=self.jobset.weights(), deadline=self.deadline_policy
            )
        return WeightedFairness(self.jobset.weights())

    # -- admission / departure ----------------------------------------------

    def admit(
        self,
        spec: JobSpec,
        k: int,
        weight: float = 1.0,
        name: str | None = None,
        now: float = 0.0,
        candidates: int | None = None,
    ) -> tuple[tuple[int, ...], float] | None:
        """Admit an arriving job: place it on ``k`` free servers, then let
        the arrival trigger replan the shared fabric.  Returns
        ``(servers, pause_seconds)`` — the servers the tenant ends up on —
        or ``None`` when free servers exist but no connected component of
        the live (degraded) fabric can host all ``k`` of them: the job is
        *refused* rather than admitted astride a partition it could never
        AllReduce across.  Refusals are recorded in :attr:`refused` as
        ``(now, label)`` so operators can re-admit after a repair.

        ``candidates`` (default: the policy's ``candidates``) switches the
        admission from greedy-then-replan to **placement co-search**: the
        diverse candidate placements of :func:`place_candidates` are each
        carried through the full replan
        (``co_optimize_jobset(placement_candidates=...)``) and the best
        full plan — placement included — is adopted.  ``candidates=1`` is
        the greedy :func:`place_arrival` path, byte-identical to the
        pre-search behaviour.  When the replan is suppressed (hysteresis,
        adaptive skip, or a policy without the arrival trigger) the tenant
        stays on the greedy seed placement.

        With ``policy.backend="torch"`` and ``policy.temperatures`` set,
        the candidate search runs **fused** on ``policy.device``: every
        screened placement candidate x the tempering ladder anneals in one
        grid program per alternating round
        (:func:`~repro_torch.core.alternating.co_optimize_jobset` with
        ``temperatures=``), with the winner hand-off staying on the device
        between rounds."""
        if k < 1:
            raise ValueError(f"admit needs k >= 1 servers, got {k}")
        n_cand = self.policy.candidates if candidates is None else candidates
        label = name or spec.name
        free = self.jobset.free_servers()
        links = self.links()
        seed_placement = place_arrival(k, free, links, require_hostable=True)
        if seed_placement is None:
            self.refused.append((now, label))
            return None
        if n_cand <= 1:
            placements = [seed_placement]
        else:
            # Hostable seed first (bit-identical to place_candidates[0] on
            # a connected fabric), then the diverse variants it didn't pick.
            placements = [seed_placement] + [
                p for p in place_candidates(k, free, links, n=n_cand)
                if p != seed_placement
            ]
        base = self.jobset
        self.jobset = base.with_tenant(
            TenantJob(spec=spec, servers=placements[0], weight=weight,
                      name=label)
        )
        self._probe_cache = None
        pause = 0.0
        if self.policy.on_arrival:
            if len(placements) > 1:
                self._pending_candidates = [
                    base.with_tenant(TenantJob(
                        spec=spec, servers=p, weight=weight, name=label))
                    for p in placements
                ]
            try:
                update = self._maybe_replan(now, "arrival")
            finally:
                self._pending_candidates = None
            if update is not None:
                pause = update.pause
        if (
            self.policy.rebalance_on_arrival
            and self.policy.max_migrations > 0
            and self.jobset.tenants
        ):
            # Admission-time preemption (not only departures rebalance):
            # offer the post-admission fabric to every
            # resident — the arrival included — so a high-value newcomer
            # can displace cheap residents when the migration-priced win
            # clears its cost.
            update = self.rebalance(now + pause, reason="arrival")
            if update is not None:
                pause += update.pause
        return self.jobset.tenant(label).servers, pause

    def depart(self, label: str, now: float = 0.0) -> float:
        """A tenant finishes: free its servers; the departure trigger may
        compact the shared fabric, and a policy with ``max_migrations > 0``
        additionally offers the freed capacity to the remaining tenants
        (:meth:`rebalance`).  Returns the pause charged (seconds)."""
        self.jobset = self.jobset.without(label)
        self._probe_cache = None
        pause = 0.0
        if self.policy.on_departure:
            update = self._maybe_replan(now, "departure")
            if update is not None:
                pause += update.pause
        if self.policy.max_migrations > 0 and self.jobset.tenants:
            update = self.rebalance(now + pause, reason="departure")
            if update is not None:
                pause += update.pause
        return pause

    # -- churn-priced tenant migration ---------------------------------------

    def _migration_proposals(
        self, n_cand: int
    ) -> list[tuple[str, tuple[int, ...]]]:
        """Fast screen: per resident tenant, its best candidate placement
        by the weighted objective *on the incumbent topology* (incremental
        :class:`~repro_torch.core.planeval.JobSetEvaluator` pricing with
        synthetic rings for virgin placements — no union rebuild, no
        optimizer run), returned ranked best-first.

        The screen is deliberately a *ranking*, not a gate: a placement the
        incumbent fabric serves badly can still win big once a replan
        rebuilds rings over it, so :meth:`rebalance` full-evaluates the
        ranked proposals in order instead of trusting the screen's absolute
        values."""
        strategies = self.strategies()
        jse = JobSetEvaluator(self.jobset, self.topology, self.hw,
                              synth_missing_rings=True)
        jse.set_strategies(strategies)
        links = self.links()
        free = self.jobset.free_servers()
        ranked: list[tuple[float, str, tuple[int, ...]]] = []
        for t in self.jobset.tenants:
            pool = free | set(t.servers)
            if t.k > len(pool):
                continue
            best: tuple[float, tuple[int, ...]] | None = None
            for servers in place_candidates(t.k, pool, links, n=n_cand):
                if set(servers) == set(t.servers):
                    continue
                obj = jse.objective_at(t.label, strategies[t.label], servers)
                if best is None or obj < best[0]:
                    best = (obj, servers)
            if best is not None:
                ranked.append((best[0], t.label, best[1]))
        ranked.sort(key=lambda r: (r[0], r[1]))
        jse.log_cache_stats("migration-screen")
        return [(label, servers) for _, label, servers in ranked]

    def rebalance(
        self,
        now: float = 0.0,
        reason: str = "departure",
        max_migrations: int | None = None,
        candidates: int | None = None,
    ) -> PlanUpdate | None:
        """Propose migrating up to ``max_migrations`` resident tenants to
        better placements, adopting each move only when its probed win
        clears its price.

        Per migration slot: rank every tenant's best candidate placement
        through the incremental evaluator on the incumbent topology
        (:meth:`_migration_proposals`), then carry the ranked proposals —
        best-screened first — through full warm-started replans on the
        moved JobSet until one is adopted (up to one replan per resident
        tenant: the screen deliberately ranks rather than gates, because
        the incumbent fabric undervalues virgin placements).  Each move is
        priced with :func:`repro_torch.core.costmodel.migration_cost` — the
        policy's ``migration_restart`` floor plus the tenant's
        checkpoint-restore transfer
        (:attr:`~repro_torch.core.workloads.JobSpec.state_bytes`) — plus the
        fiber churn of the topology swap priced exactly like a replan
        (``fiber_move_latency * edge_churn``, or the flat
        ``replan_latency``).  A move is adopted only when the probed
        per-iteration win, amortized over the policy's ``payback_horizon``,
        clears that cost; a slot in which every proposal is rejected backs
        off the adaptive interval (the same hysteresis replans use) and
        ends the pass.

        Returns a migration :class:`~repro_torch.core.simengine.PlanUpdate`
        (fabric + summed pause + per-tenant
        :class:`~repro_torch.core.simengine.MigrationRecord`\\ s) when at least
        one move was adopted, else ``None``.  Every decision — adopted or
        rejected — is appended to ``self.migrations``."""
        limit = (
            self.policy.max_migrations
            if max_migrations is None else max_migrations
        )
        if limit <= 0 or not self.jobset.tenants:
            return None
        # Only an active *adaptive backoff* suppresses rebalancing: a plain
        # min_interval must not swallow the rebalance that depart() chains
        # right after its own replan (which just stamped last_replan).  A
        # backed-off interval, by contrast, is evidence that recent fabric
        # changes did not pay for themselves.
        if (
            self.policy.adaptive
            and self._adaptive_interval > self.policy.min_interval
            and now - self.last_replan < self._adaptive_interval
        ):
            return None
        self._replan_now = now
        self.ensure_plan()
        n_cand = (
            candidates if candidates is not None
            else max(2, self.policy.candidates)
        )
        adopted: list[MigrationRecord] = []
        total_pause = 0.0
        total_churn = 0
        for _ in range(limit):
            proposals = self._migration_proposals(n_cand)
            if not proposals:
                break
            slot_adopted = False
            for label, servers in proposals:
                tenant = self.jobset.tenant(label)
                est_before = self.estimated_iter_time()
                trial = self.jobset.with_placement(label, servers)
                plan = co_optimize_jobset(
                    self._opt_jobset(trial, now), self.hw,
                    rounds=self.policy.rounds,
                    mcmc_iters=self.policy.mcmc_iters,
                    seed=self.seed + 1 + self.n_replans,
                    warm_topology=self.topology,
                    warm_strategies=self.strategies(),
                    forbidden=tuple(self.dead),
                    compiled=self.policy.compiled,
                    objective=self.policy.objective,
                    backend=self.policy.backend,
                    chains=self.policy.chains,
                    schedules=self.policy.schedules,
                    temperatures=self.policy.temperatures,
                    device=self.policy.device,
                )
                saved = self.jobset
                self.jobset = trial
                try:
                    est_after = self.estimated_iter_time(
                        topo=plan.topology, strategy=plan.strategies
                    )
                finally:
                    self.jobset = saved
                churn = edge_churn(self.topology, plan.topology)
                cost = migration_cost(
                    tenant.spec.state_bytes, edges_moved=0,
                    restart_s=self.policy.migration_restart,
                ) + self._replan_pause(churn)
                win = (est_before - est_after) * self.policy.payback_horizon
                if not np.isfinite(est_before):
                    win = np.inf if np.isfinite(est_after) else 0.0
                record = MigrationRecord(
                    time=now, tenant=label, src=tenant.servers, dst=servers,
                    est_before=est_before, est_after=est_after, cost=cost,
                    edges_moved=churn,
                    adopted=bool(est_after <= est_before and win >= cost),
                    reason=reason,
                )
                self.migrations.append(record)
                if not record.adopted:
                    continue
                self.jobset = trial
                self._adopt_plan(plan)
                self._baseline = est_after
                self._probe_cache = None
                self._adaptive_interval = self.policy.min_interval
                self.n_replans += 1
                self.total_edges_moved += churn
                self.last_replan = now
                # Keep the log/counter correspondence every replan path
                # maintains: one replanned record per n_replans bump.
                self.log.append(ReplanRecord(
                    time=now, trigger=f"rebalance:{reason}", replanned=True,
                    est_before=est_before, est_after=est_after,
                    edges_moved=churn,
                ))
                adopted.append(record)
                total_pause += cost
                total_churn += churn
                slot_adopted = True
                break
            if not slot_adopted:
                # Same backoff the adaptive replan gate uses: hopeless
                # rebalancing stops burning optimizer runs until the next
                # adopted change resets the interval.
                if self.policy.adaptive:
                    self._adaptive_interval = max(
                        2 * self._adaptive_interval,
                        self.policy.min_interval,
                    )
                break
        if not adopted:
            return None
        self.last_pause = total_pause
        update = PlanUpdate(
            links=self.links(),
            pause=total_pause,
            label=f"rebalance:{reason}",
            edges_moved=total_churn,
            migrations=tuple(adopted),
        )
        return update

    def set_job(self, job: JobSpec, now: float = 0.0) -> float:
        raise TypeError(
            "JobSetController has no single resident job; use admit/depart"
        )


# ---------------------------------------------------------------------------
# Iteration-granularity driver: static plan vs reactive replanning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceEvent:
    """One disruption in an online trace.

    ``kind="fail"``: the fiber pair ``link`` dies when iteration
    ``iteration`` starts (``frac=0``) or ``frac`` of the way through it.
    ``kind="repair"``: a previously failed ``link`` comes back at that
    iteration boundary (transient fault healed; the controller restores the
    fiber and may replan).
    ``kind="load"``: the resident job's spec becomes ``job`` (a load shift —
    bigger batch, more tables, a different model) at that iteration boundary.

    Multi-tenant traces (:func:`run_online_jobset`) additionally use
    ``kind="arrive"`` — job ``job`` joins on ``k`` servers with fairness
    ``weight`` under label ``name`` (placed by :func:`place_arrival`) — and
    ``kind="depart"`` — tenant ``name`` finishes and frees its servers.

    Unknown kinds raise :class:`ValueError` at construction — the drivers
    dispatch on ``kind``, and a typo'd kind used to be skipped silently.
    """

    KINDS = frozenset({"fail", "repair", "load", "arrive", "depart"})

    iteration: int
    kind: str  # "fail" | "repair" | "load" | "arrive" | "depart"
    link: tuple[int, int] | None = None
    frac: float = 0.0
    job: JobSpec | None = None
    k: int = 0
    weight: float = 1.0
    name: str | None = None

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(
                f"unknown TraceEvent kind {self.kind!r}; expected one of "
                f"{sorted(self.KINDS)}"
            )
        if self.kind in ("fail", "repair") and self.link is None:
            raise ValueError(
                f"TraceEvent(kind={self.kind!r}) requires a link"
            )


@dataclass
class OnlineRunResult:
    total_time: float
    iter_times: list[float] = field(default_factory=list)
    n_replans: int = 0
    n_failures: int = 0
    edges_moved: int = 0
    log: list[ReplanRecord] = field(default_factory=list)
    final_plan: CoOptResult | None = None


def run_online(
    job: JobSpec,
    n: int,
    hw: HardwareSpec | None = None,
    policy: ReoptPolicy | None = None,
    trace: tuple[TraceEvent, ...] = (),
    n_iters: int = 8,
    seed: int = 0,
    plan: CoOptResult | None = None,
    engine: SimEngine | None = None,
) -> OnlineRunResult:
    """Simulate ``n_iters`` training iterations under a disruption trace.

    Every iteration's flow graph is regenerated from the controller's
    *current* plan (so a replan changes the traffic of all later iterations,
    not just the routes of in-flight flows), then run through
    :meth:`SimEngine.run` with the controller attached as observer:
    mid-iteration failures hit the engine's failure event, the controller
    replans, and the engine swaps the fabric under the surviving flows.

    Pass ``policy=ReoptPolicy.never()`` for the static baseline — the same
    trace, but failures only get the paper's §7 repair — and share ``plan``
    between the two calls so both start from the identical offline optimum.
    """
    hw = hw or HardwareSpec()
    ctrl = ReoptController(job, n, hw=hw, policy=policy, seed=seed, plan=plan)
    ctrl.ensure_plan()
    if ctrl.policy.degradation_threshold is not None:
        ctrl.baseline  # pin the healthy-fabric baseline before disruptions
    # One SimJob per iteration: its admission is not a load shift.  Genuine
    # load shifts arrive through TraceEvent(kind="load") -> set_job below.
    ctrl.suppress_job_hooks = True
    eng = engine or SimEngine(
        hw, backend=ctrl.policy.backend, device=ctrl.policy.device
    )

    by_iter: dict[int, list[TraceEvent]] = {}
    for ev in trace:
        by_iter.setdefault(ev.iteration, []).append(ev)

    total = 0.0
    result = OnlineRunResult(total_time=0.0)
    for it in range(n_iters):
        mid_iter: list[TraceEvent] = []
        for ev in by_iter.get(it, ()):
            if ev.kind == "load" and ev.job is not None:
                total += ctrl.set_job(ev.job, now=total)
            elif ev.kind == "repair" and ev.link is not None:
                total += ctrl.repair(ev.link, now=total)
            elif ev.kind == "fail" and ev.link is not None:
                if ev.frac <= 0.0:
                    total += ctrl.fail(ev.link, now=total)
                    result.n_failures += 1
                else:
                    mid_iter.append(ev)

        cur_job = ctrl.job
        comp = compute_time(
            cur_job.flops_per_sample * cur_job.batch_per_gpu * n, n, hw
        )
        tasks = iteration_tasks(ctrl.topology, ctrl.demand,
                                compute_duration=comp)
        failures = []
        if mid_iter:  # probe only when a failure needs an in-iteration time
            est = ctrl.estimated_iter_time()
            if not np.isfinite(est):
                # Disconnected fabric: the iteration stall-finishes at t=0,
                # so land mid-iteration failures at the start.
                est = result.iter_times[-1] if result.iter_times else 0.0
            est = max(est, 1e-12)
            for ev in mid_iter:
                failures.append(LinkFailure(time=ev.frac * est, link=ev.link))
                result.n_failures += 1
        sc = Scenario(
            links=ctrl.links(),
            jobs=[SimJob(cur_job.name, tasks)],
            failures=tuple(sorted(failures, key=lambda f: f.time)),
            n=n,
        )
        ctrl.clock_offset = total  # hooks see the global training clock
        res = eng.run(sc, observer=ctrl)
        iter_time = res.makespan
        if res.replan_times:
            # A replan near the end of the iteration can leave part of its
            # pause hanging past the last task finish; charge the overhang
            # so reactive policies don't get the tail of the pause free.
            overhang = res.replan_times[-1] + ctrl.last_pause - res.makespan
            if overhang > 0:
                iter_time += overhang
        total += iter_time
        result.iter_times.append(iter_time)

    result.total_time = total
    result.n_replans = ctrl.n_replans
    result.edges_moved = ctrl.total_edges_moved
    result.log = ctrl.log
    result.final_plan = ctrl.plan
    return result


# ---------------------------------------------------------------------------
# Multi-tenant driver: a churn trace against a shared fabric
# ---------------------------------------------------------------------------


@dataclass
class JobSetRunResult:
    total_time: float
    iter_times: list[float] = field(default_factory=list)
    # Tenant -> sum of its per-iteration makespans while resident.
    job_times: dict[str, float] = field(default_factory=dict)
    n_replans: int = 0
    n_failures: int = 0
    edges_moved: int = 0
    log: list[ReplanRecord] = field(default_factory=list)
    # Every rebalance decision (adopted or rejected), in decision order.
    migrations: list[MigrationRecord] = field(default_factory=list)
    # Labels of arrivals the controller refused (no live fabric component
    # could host them), in admission order.
    refused: list[str] = field(default_factory=list)
    final_plan: JobSetPlan | None = None
    final_jobset: JobSet | None = None

    @property
    def n_migrations(self) -> int:
        return sum(1 for m in self.migrations if m.adopted)


def run_online_jobset(
    jobset: JobSet,
    hw: HardwareSpec | None = None,
    policy: ReoptPolicy | None = None,
    trace: tuple[TraceEvent, ...] = (),
    n_iters: int = 8,
    seed: int = 0,
    plan: JobSetPlan | None = None,
    engine: SimEngine | None = None,
) -> JobSetRunResult:
    """Simulate ``n_iters`` training iterations of a *shared* cluster under
    a churn trace: jobs arriving (placed via :func:`place_arrival`) and
    departing, fibers dying at or inside iteration boundaries.

    Each iteration regenerates one SimJob per resident tenant from the
    controller's current shared plan and runs them through
    :meth:`SimEngine.run` contending under the set's weighted fairness, with
    the :class:`JobSetController` attached as observer.  Pass
    ``policy=ReoptPolicy.never()`` for the static shared baseline and share
    ``plan`` so both operators start from the same offline optimum.

    Placement knobs ride the policy: ``candidates > 1`` co-searches each
    arrival's placement through the replan, and ``max_migrations > 0``
    lets departures trigger churn-priced rebalancing
    (:meth:`JobSetController.rebalance`) — every migration decision lands
    in ``JobSetRunResult.migrations``.
    """
    hw = hw or HardwareSpec()
    ctrl = JobSetController(jobset, hw=hw, policy=policy, seed=seed, plan=plan)
    ctrl.ensure_plan()
    if ctrl.policy.degradation_threshold is not None:
        ctrl.baseline  # pin the healthy-fabric baseline before disruptions
    ctrl.suppress_job_hooks = True
    eng = engine or SimEngine(
        hw, backend=ctrl.policy.backend, device=ctrl.policy.device
    )

    by_iter: dict[int, list[TraceEvent]] = {}
    for ev in trace:
        by_iter.setdefault(ev.iteration, []).append(ev)

    total = 0.0
    result = JobSetRunResult(total_time=0.0)
    for it in range(n_iters):
        mid_iter: list[TraceEvent] = []
        for ev in by_iter.get(it, ()):
            if ev.kind == "arrive" and ev.job is not None:
                admitted = ctrl.admit(
                    ev.job, ev.k, weight=ev.weight, name=ev.name, now=total,
                )
                if admitted is not None:
                    total += admitted[1]
            elif ev.kind == "depart" and ev.name:
                total += ctrl.depart(ev.name, now=total)
            elif ev.kind == "repair" and ev.link is not None:
                total += ctrl.repair(ev.link, now=total)
            elif ev.kind == "fail" and ev.link is not None:
                if ev.frac <= 0.0:
                    total += ctrl.fail(ev.link, now=total)
                    result.n_failures += 1
                else:
                    mid_iter.append(ev)

        if not ctrl.jobset.tenants:
            # No resident work: the iteration is instantaneous, but queued
            # mid-iteration failures still land on the fabric.
            for ev in mid_iter:
                total += ctrl.fail(ev.link, now=total)
                result.n_failures += 1
            result.iter_times.append(0.0)
            continue
        jobs = ctrl.iteration_jobs()
        failures = []
        if mid_iter:
            est = ctrl.estimated_iter_time()
            if not np.isfinite(est):
                est = result.iter_times[-1] if result.iter_times else 0.0
            est = max(est, 1e-12)
            for ev in mid_iter:
                failures.append(LinkFailure(time=ev.frac * est, link=ev.link))
                result.n_failures += 1
        sc = Scenario(
            links=ctrl.links(),
            jobs=jobs,
            failures=tuple(sorted(failures, key=lambda f: f.time)),
            n=jobset.n,
            fairness=ctrl.fairness(),
        )
        ctrl.clock_offset = total
        res = eng.run(sc, observer=ctrl)
        iter_time = res.makespan
        if res.replan_times:
            overhang = res.replan_times[-1] + ctrl.last_pause - res.makespan
            if overhang > 0:
                iter_time += overhang
        total += iter_time
        result.iter_times.append(iter_time)
        for name, ms in res.job_makespans.items():
            result.job_times[name] = result.job_times.get(name, 0.0) + ms

    result.total_time = total
    result.n_replans = ctrl.n_replans
    result.edges_moved = ctrl.total_edges_moved
    result.log = ctrl.log
    result.migrations = list(ctrl.migrations)
    result.refused = [label for _, label in ctrl.refused]
    result.final_plan = ctrl.plan
    result.final_jobset = ctrl.jobset
    return result


# ---------------------------------------------------------------------------
# Topology-aware placement of arriving jobs
# ---------------------------------------------------------------------------


def _free_capacity_matrix(
    free: set[int] | frozenset[int],
    links: dict[tuple[int, int], float],
) -> tuple[np.ndarray, np.ndarray, list[list[int]]]:
    """(sorted free server ids, symmetric free-to-free capacity matrix,
    per-row neighbor first-touch order).

    ``A[i, j]`` sums both directions of every live link between free
    servers ``i`` and ``j`` — the adjacency the greedy packer and every
    candidate generator scan, built once per call instead of rebuilding a
    nested dict per step.  ``touch_order[i]`` lists ``i``'s neighbor
    columns in the order they first appeared in ``links`` — the dict
    reference summed each server's capacities in exactly that order, and
    float addition is order-sensitive at the last ulp, so bit-identical
    tie-breaking must replay it."""
    ids = np.asarray(sorted(free), dtype=np.int64)
    index = {int(v): i for i, v in enumerate(ids)}
    m = ids.size
    a_mat = np.zeros((m, m), dtype=np.float64)
    touch_order: list[list[int]] = [[] for _ in range(m)]
    for (a, b), c in links.items():
        ia = index.get(a)
        ib = index.get(b)
        if ia is not None and ib is not None and c > 0:
            if a_mat[ia, ib] == 0.0:
                touch_order[ia].append(ib)
            if a_mat[ib, ia] == 0.0:
                touch_order[ib].append(ia)
            a_mat[ia, ib] += c
            a_mat[ib, ia] += c
    return ids, a_mat, touch_order


def _greedy_pack(
    ids: np.ndarray,
    a_mat: np.ndarray,
    k: int,
    allowed: np.ndarray,
    touch_order: list[list[int]],
) -> tuple[int, ...]:
    """Greedy capacity packing over the ``allowed`` subset of a prebuilt
    free-capacity matrix (the :func:`place_arrival` algorithm body).

    Total capacities are summed per row in ``touch_order`` — the dict
    reference's neighbor insertion order — because float addition is
    order-sensitive at the last ulp and a last-ulp difference can flip a
    tie-break.  Restricting to a subset reproduces a fresh build over that
    subset bit for bit: the reduced build's insertion order is the same
    subsequence of ``links``, and the capacity-toward-chosen vector
    accumulates one column per pick exactly like the reference's
    chosen-order walk (its zero addends for non-neighbors cannot change a
    float sum)."""
    sub = np.flatnonzero(allowed)
    sub_ids = ids[sub]
    sub_mat = a_mat[np.ix_(sub, sub)]
    total = np.zeros(sub.size, dtype=np.float64)
    for si, i in enumerate(sub):
        acc = 0.0
        for j in touch_order[i]:
            if allowed[j]:
                acc += a_mat[i, j]
        total[si] = acc
    # np.lexsort is stable ascending, last key primary; ids ascending break
    # full ties toward the lowest id exactly like the dict reference.
    seed = int(np.lexsort((sub_ids, -total))[0])
    chosen_mask = np.zeros(sub.size, dtype=bool)
    chosen_mask[seed] = True
    cap_chosen = sub_mat[:, seed].copy()
    for _ in range(k - 1):
        pool = np.flatnonzero(~chosen_mask)
        order = np.lexsort(
            (sub_ids[pool], -total[pool], -cap_chosen[pool])
        )
        nxt = int(pool[order[0]])
        chosen_mask[nxt] = True
        cap_chosen += sub_mat[:, nxt]
    return tuple(int(v) for v in sub_ids[chosen_mask])


def _live_components(
    free_ids: np.ndarray, links: dict[tuple[int, int], float]
) -> np.ndarray:
    """Component label per free server under the live fabric's *undirected*
    connectivity (positive-capacity links; paths may transit busy servers).
    Free servers with no live fiber at all become singleton components."""
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (a, b), c in links.items():
        if c > 0:
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[rb] = ra
    return np.asarray([find(int(v)) for v in free_ids], dtype=np.int64)


def place_arrival(
    k: int,
    free: set[int] | frozenset[int],
    links: dict[tuple[int, int], float],
    require_hostable: bool = False,
) -> tuple[int, ...] | None:
    """Pick ``k`` free servers for a newly arriving job, topology-aware.

    Greedy capacity packing: seed with the free server carrying the most
    surviving capacity toward other free servers, then repeatedly add the
    free server with the highest live capacity toward the chosen set.  On a
    degraded fabric this steers new jobs away from servers whose fibers died;
    on a healthy one it reduces fabric fragmentation versus lowest-id
    first-fit.  Falls back to lowest ids to break ties deterministically.

    ``require_hostable=True`` additionally demands that the ``k`` servers
    share one connected component of the live fabric (a job split across a
    partition can never finish an AllReduce).  When the plain greedy pick
    straddles a partition, the pack is retried inside the component holding
    the most free servers (ties toward the one with the smallest id);
    returns ``None`` when *no* live component has ``k`` free servers — the
    degraded-fabric signal :meth:`JobSetController.admit` turns into a
    refused admission.  On a connected fabric the flag is a no-op and the
    result is bit-identical to the default path.

    Vectorized: one symmetric NumPy adjacency over the free servers
    replaces the per-step dict scans; each selection is a stable
    lexicographic argmax on (cap to chosen, total cap, id), bit-identical
    to the dict reference (see :func:`_greedy_pack`).
    """
    free = set(free)
    if k > len(free):
        raise ValueError(f"need {k} servers, only {len(free)} free")
    if k == 0:
        return ()
    ids, a_mat, touch = _free_capacity_matrix(free, links)
    chosen = _greedy_pack(ids, a_mat, k, np.ones(ids.size, dtype=bool), touch)
    if not require_hostable or k == 1:
        return chosen  # a single-server tenant has no network demand
    comp = _live_components(ids, links)
    label_of = dict(zip(ids.tolist(), comp.tolist()))
    if len({label_of[v] for v in chosen}) == 1:
        return chosen  # greedy pick already lives inside one component
    # The fabric is partitioned under the free pool: retry inside the
    # component with the most free servers (ties -> smallest server id).
    best_label: int | None = None
    best_key: tuple[int, int] | None = None
    for label in dict.fromkeys(comp.tolist()):
        mask = comp == label
        size = int(mask.sum())
        if size < k:
            continue
        key = (-size, int(ids[mask][0]))
        if best_key is None or key < best_key:
            best_key, best_label = key, label
    if best_label is None:
        return None
    return _greedy_pack(ids, a_mat, k, comp == best_label, touch)


def place_candidates(
    k: int,
    free: set[int] | frozenset[int],
    links: dict[tuple[int, int], float],
    n: int = 4,
) -> list[tuple[int, ...]]:
    """Diverse candidate placements for a ``k``-server job — the input of
    the placement co-search (``co_optimize_jobset(placement_candidates=)``).

    Always seeds with the greedy capacity packing (:func:`place_arrival`)
    so candidate 0 *is* today's placement; then adds deterministic
    variants, deduplicated in order:

    * **contiguous** — the ``k`` consecutive free ids with the smallest id
      span (dense blocks keep short ring strides constructible);
    * **spread** — every ``len(free)/k``-th free server by id (leaves the
      largest contiguous holes for future arrivals);
    * **anti-affinity** — the ``k`` free servers with the *least* live
      capacity toward occupied servers (stays out of resident tenants'
      fabric neighborhoods);
    * further greedy packs with the previous seeds' top-connected server
      excluded, until ``n`` distinct candidates exist or variants repeat.

    Returns at most ``n`` distinct placements, greedy first.
    """
    free = set(free)
    if k > len(free):
        raise ValueError(f"need {k} servers, only {len(free)} free")
    if k == 0:
        return [()]
    out: list[tuple[int, ...]] = []

    def _add(p: tuple[int, ...]) -> None:
        if len(p) == k and p not in out:
            out.append(p)

    # One adjacency build serves the greedy seed, the hot-server ranking,
    # and every exclusion variant below.
    ids, a_mat, touch = _free_capacity_matrix(free, links)
    all_allowed = np.ones(ids.size, dtype=bool)
    _add(_greedy_pack(ids, a_mat, k, all_allowed, touch))
    if n <= 1:
        return out[:n]

    ordered = sorted(free)
    # Contiguous: k-window of sorted free ids minimizing the id span.
    spans = [
        (ordered[i + k - 1] - ordered[i], ordered[i], i)
        for i in range(len(ordered) - k + 1)
    ]
    _, _, i0 = min(spans)
    _add(tuple(ordered[i0:i0 + k]))
    # Spread: every ~len/k-th free id (stride >= 1, indices distinct).
    stride = len(ordered) / k
    _add(tuple(ordered[int(i * stride)] for i in range(k)))
    # Anti-affinity: least live capacity toward busy (non-free) servers.
    busy_cap = {v: 0.0 for v in ordered}
    for (a, b), c in links.items():
        if c <= 0:
            continue
        if a in busy_cap and b not in busy_cap:
            busy_cap[a] += c
        elif b in busy_cap and a not in busy_cap:
            busy_cap[b] += c
    _add(tuple(sorted(
        sorted(ordered, key=lambda v: (busy_cap[v], v))[:k]
    )))
    # Extra diversity: greedy packs avoiding the best-connected servers.
    by_total = np.lexsort((ids, -a_mat.sum(axis=1)))
    allowed = all_allowed.copy()
    for hot in by_total:
        if len(out) >= n:
            break
        allowed[hot] = False
        if k > int(allowed.sum()):
            break
        _add(_greedy_pack(ids, a_mat, k, allowed, touch))
    return out[:n]
