"""Workload characterizations for the paper's six DNN models (§5.1, List 1)
and for the assigned architectures (traffic-demand view).

Each :class:`JobSpec` captures what the co-optimization needs: dense
(replicated) parameter bytes -> AllReduce demand; embedding tables / experts
-> MP demand; FLOPs -> compute time.

Multi-tenant clusters (§6 shared-cluster deployment): a :class:`JobSet`
holds several :class:`TenantJob`\\ s — a spec, a disjoint server placement,
and a fairness weight each — and aggregates their per-job demands into one
cluster-level :class:`~repro_torch.core.demand.TrafficDemand` via
:meth:`JobSet.union`.  That union is what the shared TopologyFinder packs
into one physical degree budget.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Mapping, Sequence

from .demand import (
    TrafficDemand,
    data_parallel_demand,
    dlrm_demand,
    moe_demand,
    remap_demand,
    union_demand,
)


@dataclass(frozen=True)
class JobSpec:
    name: str
    batch_per_gpu: int
    dense_params: float  # replicated parameter count
    flops_per_sample: float
    # Embedding-table models (DLRM/NCF): tables create MP broadcast+incast.
    n_tables: int = 0
    table_rows: float = 0.0
    table_dim: int = 0
    # MoE models: EP all-to-all.
    n_experts: int = 0
    top_k: int = 0
    moe_hidden: int = 0
    d_model: int = 0
    n_moe_layers: int = 0
    bytes_per_param: int = 4
    bytes_per_activation: int = 4

    @property
    def dense_bytes(self) -> float:
        return self.dense_params * self.bytes_per_param

    @property
    def state_bytes(self) -> float:
        """Bytes of model state a migration must checkpoint-restore: dense
        parameters plus embedding tables plus expert weights (the migration
        cost model, :func:`repro_torch.core.costmodel.migration_cost`, owns any
        optimizer-state multiplier)."""
        params = (
            self.dense_params
            + self.n_tables * self.table_rows * self.table_dim
            + self.n_moe_layers * self.n_experts * 3 * self.d_model
            * self.moe_hidden
        )
        return params * self.bytes_per_param

    def with_batch(self, batch_per_gpu: int) -> "JobSpec":
        return replace(self, batch_per_gpu=batch_per_gpu)


# --- List 1 (§5.3 configurations) -----------------------------------------

VGG16 = JobSpec(
    name="vgg16", batch_per_gpu=64, dense_params=138e6, flops_per_sample=3 * 15.5e9
)
RESNET50 = JobSpec(
    name="resnet50", batch_per_gpu=128, dense_params=25.6e6, flops_per_sample=3 * 4.1e9
)
BERT = JobSpec(
    # 12 blocks, hidden 1024, seq 64, embed 512.
    name="bert", batch_per_gpu=16, dense_params=152e6,
    flops_per_sample=6 * 152e6 * 64,
)
CANDLE = JobSpec(
    # 8 dense layers of 16384 + 16 feature layers of 16384: ~ 5.4e9 params.
    name="candle", batch_per_gpu=256, dense_params=5.4e9,
    flops_per_sample=2 * 3 * 5.4e9,
)
DLRM = JobSpec(
    # 64 tables x 1e7 rows x 128 dims; 8 dense 2048 + 16 feat 4096.
    name="dlrm", batch_per_gpu=128,
    dense_params=8 * 2048**2 + 16 * 4096**2,
    flops_per_sample=2 * 3 * (8 * 2048**2 + 16 * 4096**2),
    n_tables=64, table_rows=1e7, table_dim=128,
)
DLRM_A2A = JobSpec(  # §5.4 worst-case: 128 large tables on 128 servers,
    # embedding dims boosted ("128x relative to state-of-the-art", §6) so
    # all-to-all reaches ~80% of AllReduce at batch 2048 as in Fig. 12.
    name="dlrm_a2a", batch_per_gpu=128,
    dense_params=8 * 2048**2 + 16 * 4096**2,
    flops_per_sample=2 * 3 * (8 * 2048**2 + 16 * 4096**2),
    n_tables=128, table_rows=1e7, table_dim=1024,
)
NCF = JobSpec(
    # 64 MF + 64 MLP tables of 1e6 users/items; dense 8 x 4096.
    name="ncf", batch_per_gpu=128, dense_params=8 * 4096**2,
    flops_per_sample=2 * 3 * 8 * 4096**2,
    n_tables=128, table_rows=1e6, table_dim=96,  # mean of MF 64 / MLP 128
)

MOE_16E = JobSpec(
    # Small mixture-of-experts transformer (shared-cluster churn traces):
    # 16 experts, top-2 routing, 8 MoE layers -> EP all-to-all demand.
    name="moe16", batch_per_gpu=32, dense_params=200e6,
    flops_per_sample=6 * 200e6 * 32,
    n_experts=16, top_k=2, moe_hidden=2048, d_model=1024, n_moe_layers=8,
)

PAPER_JOBS = {
    j.name: j for j in [VGG16, RESNET50, BERT, CANDLE, DLRM, DLRM_A2A, NCF]
}


# --- Multi-tenant JobSet (shared-cluster co-optimization) -------------------


@dataclass(frozen=True)
class TenantJob:
    """One resident job of a shared cluster: spec + placement + weight.

    ``servers`` maps the job's local node ids ``0..k-1`` to cluster nodes;
    placements of distinct tenants must be disjoint.  ``weight`` is the
    job's fairness weight (weighted max-min share and objective weight in
    the multi-job co-optimization)."""

    spec: JobSpec
    servers: tuple[int, ...]
    weight: float = 1.0
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "servers", tuple(int(s) for s in self.servers))
        if len(set(self.servers)) != len(self.servers):
            raise ValueError(f"tenant placement {self.servers!r} repeats a server")
        if self.weight <= 0:
            raise ValueError("tenant weight must be positive")

    @property
    def label(self) -> str:
        return self.name or self.spec.name

    @property
    def k(self) -> int:
        return len(self.servers)

    @property
    def flops_per_iteration(self) -> float:
        return self.spec.flops_per_sample * self.spec.batch_per_gpu * self.k


@dataclass
class JobSet:
    """The resident jobs of one shared cluster of ``n`` servers.

    Aggregates per-job (job-local) :class:`TrafficDemand`\\ s under each
    tenant's placement into one cluster-level union demand — the input the
    shared TopologyFinder packs into a single physical degree budget — and
    carries the per-job fairness weights every layer above consumes.
    """

    n: int
    tenants: list[TenantJob] = field(default_factory=list)

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        seen: set[int] = set()
        labels: set[str] = set()
        for t in self.tenants:
            if t.label in labels:
                raise ValueError(f"duplicate tenant label {t.label!r}")
            labels.add(t.label)
            s = set(t.servers)
            if s & seen:
                raise ValueError(
                    f"tenant {t.label!r} overlaps servers {sorted(s & seen)}"
                )
            if s and (min(s) < 0 or max(s) >= self.n):
                raise ValueError(
                    f"tenant {t.label!r} placed outside cluster of {self.n}"
                )
            seen |= s

    def tenant(self, label: str) -> TenantJob:
        for t in self.tenants:
            if t.label == label:
                return t
        raise KeyError(label)

    @property
    def labels(self) -> tuple[str, ...]:
        return tuple(t.label for t in self.tenants)

    def weights(self) -> dict[str, float]:
        return {t.label: t.weight for t in self.tenants}

    @property
    def total_weight(self) -> float:
        return float(sum(t.weight for t in self.tenants)) or 1.0

    def free_servers(self) -> set[int]:
        used = {s for t in self.tenants for s in t.servers}
        return set(range(self.n)) - used

    def restart_costs(self) -> dict[str, float]:
        """Per-tenant fault-restart pause (seconds): the checkpoint-restore
        reload of each tenant's model state
        (:func:`repro_torch.core.costmodel.checkpoint_restart_s`).  Feed the
        result into :attr:`repro_torch.core.simengine.Scenario.restart_s` so a
        fabric partition that stalls a tenant charges its real
        restore-from-checkpoint time when the partition heals."""
        from .costmodel import checkpoint_restart_s

        return {
            t.label: checkpoint_restart_s(t.spec.state_bytes)
            for t in self.tenants
        }

    def with_tenant(self, tenant: TenantJob) -> "JobSet":
        return JobSet(n=self.n, tenants=[*self.tenants, tenant])

    def without(self, label: str) -> "JobSet":
        kept = [t for t in self.tenants if t.label != label]
        if len(kept) == len(self.tenants):
            raise KeyError(label)
        return JobSet(n=self.n, tenants=kept)

    def with_placement(self, label: str, servers: Sequence[int]) -> "JobSet":
        """The same set with tenant ``label`` moved to ``servers`` (a
        candidate placement or an adopted migration); every other tenant is
        untouched.  Validation re-runs, so an overlapping move raises."""
        moved = [
            replace(t, servers=tuple(int(s) for s in servers))
            if t.label == label else t
            for t in self.tenants
        ]
        if all(t.label != label for t in self.tenants):
            raise KeyError(label)
        return JobSet(n=self.n, tenants=moved)

    def union(self, demands: Mapping[str, TrafficDemand]) -> TrafficDemand:
        """Cluster-level union of per-tenant job-local demands.

        ``demands[label]`` is tenant ``label``'s demand on ``tenant.k``
        local nodes; each is embedded under its placement and summed.  At
        or above the sparse threshold
        (:func:`~repro_torch.core.demand.sparse_min_nodes`) the union is built
        straight from each tenant's COO entries
        (:func:`~repro_torch.core.demand.union_embedded`, bit-identical) so no
        per-tenant (n, n) matrix is ever materialized."""
        from .demand import sparse_min_nodes, union_embedded

        if self.n >= sparse_min_nodes():
            return union_embedded(
                ((demands[t.label], t.servers) for t in self.tenants),
                self.n,
            )
        parts = [
            remap_demand(demands[t.label], t.servers, self.n)
            for t in self.tenants
        ]
        return union_demand(parts, n=self.n)

    def union_for(self, strategies: Mapping[str, object]) -> TrafficDemand:
        """Union demand under per-tenant strategies: ``strategies[label]``
        is any object with a ``demand(spec, n)`` method (a
        :class:`~repro_torch.core.strategy_search.Strategy`)."""
        return self.union({
            t.label: strategies[t.label].demand(t.spec, t.k)
            for t in self.tenants
        })


def placement_diff(
    old: JobSet, new: JobSet
) -> dict[str, tuple[tuple[int, ...], tuple[int, ...]]]:
    """Tenants whose server set differs between two JobSets:
    ``{label: (old_servers, new_servers)}``.  Labels present in only one set
    (admissions, departures) are ignored — the diff prices *migrations*, and
    a migration needs both endpoints."""
    old_by = {t.label: t.servers for t in old.tenants}
    diff: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {}
    for t in new.tenants:
        before = old_by.get(t.label)
        if before is not None and set(before) != set(t.servers):
            diff[t.label] = (before, t.servers)
    return diff


# --- Demand construction given a strategy ----------------------------------


def job_demand(
    job: JobSpec,
    n: int,
    table_hosts: Sequence[int] | None = None,
    ep_group_size: int = 0,
    schedule: str = "ring",
) -> TrafficDemand:
    """Translate (job, parallelization strategy) -> per-iteration demand.

    ``table_hosts`` None => pure data parallelism (embedding tables, if any,
    are replicated and join the AllReduce — the paper's Fig. 1a 44 GB case).
    ``schedule`` picks the collective schedule the AllReduce groups compile
    under (:mod:`repro_torch.core.schedules`); ``"ring"`` is the byte-identical
    default (groups stay mutable ring demand).
    """
    if schedule != "ring":
        from .schedules import apply_schedule

        return apply_schedule(
            job_demand(job, n, table_hosts=table_hosts,
                       ep_group_size=ep_group_size),
            schedule,
        )
    if job.n_experts and ep_group_size > 1:
        # Clamp to the job's node count (a tenant's shard may be smaller
        # than the strategy's preferred EP group).
        ep_group_size = min(ep_group_size, n)
        groups = [
            tuple(range(g, min(g + ep_group_size, n)))
            for g in range(0, n, ep_group_size)
        ]
        # Tokens routed to top_k experts: dispatch + combine per MoE layer.
        tokens = job.batch_per_gpu
        a2a_bytes = (
            2 * job.n_moe_layers * tokens * job.top_k * job.d_model
            * job.bytes_per_activation / max(1, ep_group_size - 1)
        )
        expert_params = (
            job.n_moe_layers * job.n_experts * 3 * job.d_model * job.moe_hidden
            / max(1, n // ep_group_size)
        )
        return moe_demand(
            n, job.dense_bytes, groups, a2a_bytes,
            expert_param_bytes=expert_params * job.bytes_per_param,
        )

    if job.n_tables and table_hosts:
        table_hosts = tuple(sorted(set(table_hosts)))
        # Activations out per host per iteration: every other server's batch
        # worth of looked-up rows for the tables this host owns.
        tables_per_host = job.n_tables / len(table_hosts)
        act = (
            job.batch_per_gpu * job.table_dim * job.bytes_per_activation
            * tables_per_host
        )
        return dlrm_demand(n, job.dense_bytes, table_hosts, act)

    params = job.dense_params
    if job.n_tables:
        params = params + job.n_tables * job.table_rows * job.table_dim
    return data_parallel_demand(n, params * job.bytes_per_param)
