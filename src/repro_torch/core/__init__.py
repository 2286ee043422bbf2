"""TopoOpt's planner, the paper's contribution, in the port.

The NumPy modules are forks of the JAX package's ``repro.core`` (same
names and signatures; the tests hold each to its original);
:mod:`~repro_torch.core.planeval_torch` is the device path, in torch
float64, that the JAX package runs in ``planeval_jax``:

- totient / select_perms: TotientPerms + SelectPermutations (Alg. 2/3)
- topology_finder: TopologyFinder (Alg. 1) + failure repair/degradation
- routing: CoinChangeMod (Alg. 4), k-shortest MP routes, bandwidth tax
- demand / workloads / schedules: traffic demand extraction per strategy
- planeval: the compiled NumPy plan evaluator (the bit-exact oracle)
- planeval_torch: batched pricing and MCMC chains on a torch device
- strategy_search / alternating: MCMC + alternating optimization (Fig. 6)
  and fused admission, ``backend="torch"`` (the default: the card) or
  ``"numpy"`` (the host walk)
- simengine / netsim / ocs_reconfig: the fluid and flow simulators
- online: ReoptPolicy/ReoptController/JobSetController/run_online[_jobset] —
  TopoOpt re-planning on failures, arrivals and departures (the replans and
  the fused admission on the card by default), plus topology-aware placement
- faults: seeded fault storms (FaultModel, correlated failure domains)
- fabrics / scheduler: the §5 baseline fabrics and App. C's look-ahead
  scheduler; packetsim: a deprecated shim over simengine
- costmodel: §5.2 cost analysis
"""

from .alternating import (
    CoOptResult,
    JobSetPlan,
    alternating_optimize,
    co_optimize_jobset,
    initial_topology,
)
from .costmodel import migration_cost
from .demand import (
    AllReduceGroup,
    TrafficDemand,
    rebase_demand,
    remap_demand,
    union_demand,
)
from .netsim import HardwareSpec, _iteration_time as iteration_time, compute_time
from .online import (
    JobSetController,
    ReoptController,
    ReoptPolicy,
    TraceEvent,
    edge_churn,
    place_arrival,
    place_candidates,
    run_online,
    run_online_jobset,
)
from .planeval import JobSetEvaluator, LRUCache, PlanEvaluator, plan_evaluator
from .planeval_torch import (
    TORCH_EQUIV_RTOL,
    TorchChainKernel,
    TorchPlanEvaluator,
    torch_plan_evaluator,
)
from .routing import bandwidth_tax, coin_change_mod, path_length_stats
from .select_perms import coin_change_diameter, select_permutations, theorem1_bound
from .simengine import (
    DeadlineFairness,
    FairnessPolicy,
    MigrationRecord,
    SimEngine,
    WeightedFairness,
)
from .strategy_search import (
    Strategy,
    mcmc_search,
    mcmc_search_jobset,
    tenant_comm_times,
)
from .topology_finder import Topology, remove_pair, repair_topology, topology_finder
from .totient import RingPermutation, coprimes, prime_coprimes, ring_edges, totient_perms
from .workloads import (
    PAPER_JOBS,
    JobSet,
    JobSpec,
    TenantJob,
    job_demand,
    placement_diff,
)

__all__ = [
    "AllReduceGroup",
    "CoOptResult",
    "DeadlineFairness",
    "FairnessPolicy",
    "HardwareSpec",
    "JobSet",
    "JobSetController",
    "JobSetEvaluator",
    "JobSetPlan",
    "JobSpec",
    "LRUCache",
    "MigrationRecord",
    "PlanEvaluator",
    "PAPER_JOBS",
    "ReoptController",
    "ReoptPolicy",
    "RingPermutation",
    "SimEngine",
    "Strategy",
    "TORCH_EQUIV_RTOL",
    "TenantJob",
    "Topology",
    "TorchChainKernel",
    "TraceEvent",
    "TorchPlanEvaluator",
    "TrafficDemand",
    "WeightedFairness",
    "alternating_optimize",
    "bandwidth_tax",
    "co_optimize_jobset",
    "coin_change_diameter",
    "coin_change_mod",
    "compute_time",
    "coprimes",
    "edge_churn",
    "initial_topology",
    "iteration_time",
    "job_demand",
    "mcmc_search",
    "mcmc_search_jobset",
    "migration_cost",
    "path_length_stats",
    "place_arrival",
    "place_candidates",
    "placement_diff",
    "plan_evaluator",
    "prime_coprimes",
    "rebase_demand",
    "remap_demand",
    "remove_pair",
    "repair_topology",
    "ring_edges",
    "run_online",
    "run_online_jobset",
    "select_permutations",
    "tenant_comm_times",
    "theorem1_bound",
    "topology_finder",
    "torch_plan_evaluator",
    "totient_perms",
    "union_demand",
]
