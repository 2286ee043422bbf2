"""The port's online layer (``repro_torch.core.online`` and the rest of the
planner: ``faults``, ``fabrics``, ``scheduler``, ``packetsim``) against the
JAX package's.

* **NumPy fork, to the bit:** ``run_online`` / ``run_online_jobset`` and the
  controllers with ``backend="numpy"`` give the reference default backend's
  results: totals, per-iteration times, replan records, migrations, final
  placements and topology edges, mirroring ``tests/test_online.py``'s
  reactive, degradation, hysteresis and load-shift cases and
  ``tests/test_multitenant.py``'s churn case.
* **Torch on the CPU against the JAX backend:** ``JobSetController.admit``
  under the fused ladder (``tests/test_admission_fused.py``'s controller
  case) with ``backend="torch", device="cpu"`` adopts the JAX backend's
  winner: servers, candidate, strategies, topology, ``iter_time`` to the bit.
* **Faults, scheduler, fabrics:** fault streams, scheduler records and the
  baseline fabrics equal the reference's; the storm-backoff and deadline
  cases of ``tests/test_faults.py`` replay on the port's controller.
* **packetsim:** the shim warns and forwards (``tests/test_deprecation.py``).
* **Backend rules:** ``"jax"`` and a ladder on ``"numpy"`` are refused, and
  a default replan raises without a card instead of planning on the CPU.
"""

import dataclasses
import time
import warnings

import networkx as nx
import numpy as np
import pytest
import torch

from repro.core import alternating as ref_alt
from repro.core import fabrics as ref_fabrics
from repro.core import faults as ref_faults
from repro.core import online as ref_online
from repro.core import scheduler as ref_scheduler
from repro.core import workloads as ref_wl
from repro.core.demand import data_parallel_demand as ref_dp_demand
from repro.core.netsim import HardwareSpec as RefHW

from repro_torch.core import alternating as alt
from repro_torch.core import fabrics, faults, online, packetsim, scheduler, simengine
from repro_torch.core import planeval_torch as pt
from repro_torch.core import workloads as wl
from repro_torch.core.demand import data_parallel_demand
from repro_torch.core.netsim import HardwareSpec
from repro_torch.core.strategy_search import evaluate_jobset

torch.set_num_threads(2)  # several test processes share the cores

HW = HardwareSpec(link_bandwidth=12.5e9, degree=4)
REF_HW = RefHW(link_bandwidth=12.5e9, degree=4)
N = 12
CPU = "cpu"
NUMPY = dict(backend="numpy")  # the port's host walk; the reference's default


def _edges(topo):
    return sorted(topo.graph.edges())


def _plan_view(plan):
    """A plan's comparable content: strategies by repr, edges, iter_time."""
    strategies = plan.strategies if hasattr(plan, "strategies") else {"": plan.strategy}
    return ({k: repr(v) for k, v in strategies.items()}, _edges(plan.topology),
            plan.iter_time)


def _run_view(r):
    """Everything a run result reports, floats exact (repr of the records)."""
    view = dict(total_time=r.total_time, iter_times=r.iter_times, n_replans=r.n_replans,
                n_failures=r.n_failures, edges_moved=r.edges_moved, log=repr(r.log),
                plan=_plan_view(r.final_plan))
    if hasattr(r, "final_jobset"):
        view.update(job_times=r.job_times, migrations=repr(r.migrations),
                    refused=r.refused,
                    placements={t.label: t.servers for t in r.final_jobset.tenants})
    return view


# ---------------------------------------------------------------------------
# NumPy fork: replays equal the reference's to the bit
# ---------------------------------------------------------------------------


def _dlrm_plan(mod, wmod, hw, **kw):
    return mod.alternating_optimize(wmod.DLRM, N, hw, rounds=2, mcmc_iters=20, seed=2, **kw)


def _jobset(wmod, n=N):
    return wmod.JobSet(n=n, tenants=[
        wmod.TenantJob(spec=wmod.DLRM, servers=tuple(range(0, 5)), name="dlrm"),
        wmod.TenantJob(spec=wmod.BERT, servers=tuple(range(5, 10)), weight=2.0,
                       name="bert"),
    ])


@pytest.fixture(scope="module")
def plans():
    """Each package plans with its own (NumPy) backend; the plans agree."""
    ref = dict(dlrm=_dlrm_plan(ref_alt, ref_wl, REF_HW),
               shared=ref_alt.co_optimize_jobset(_jobset(ref_wl), REF_HW, rounds=2,
                                                 mcmc_iters=20, seed=3))
    port = dict(dlrm=_dlrm_plan(alt, wl, HW, **NUMPY),
                shared=alt.co_optimize_jobset(_jobset(wl), HW, rounds=2, mcmc_iters=20,
                                              seed=3, **NUMPY))
    for k in ref:
        assert _plan_view(port[k]) == _plan_view(ref[k]), k
    return ref, port


def _fail_trace(om, wmod=None):
    return (om.TraceEvent(iteration=1, kind="fail", link=(0, 1)),
            om.TraceEvent(iteration=2, kind="fail", link=(2, 5), frac=0.5))


def _churn_trace(om, wmod):
    return (om.TraceEvent(iteration=1, kind="arrive", job=wmod.MOE_16E, k=2, name="moe"),
            om.TraceEvent(iteration=2, kind="fail", link=(0, 3)),
            om.TraceEvent(iteration=3, kind="depart", name="bert"))


# name -> (driver, policy(om, **backend), trace(om, wmod), n_iters)
REPLAYS = {
    "static": ("job", lambda om, **b: om.ReoptPolicy.never(), _fail_trace, 5),
    "reactive": ("job", lambda om, **b: om.ReoptPolicy(replan_latency=1e-3, **b),
                 _fail_trace, 5),
    "degradation": ("job", lambda om, **b: om.ReoptPolicy.degradation(
        threshold=1.05, check_interval=0.01, replan_latency=1e-3, **b), _fail_trace, 4),
    "hysteresis": ("job", lambda om, **b: om.ReoptPolicy(
        on_failure=True, min_interval=10.0, replan_latency=1e-3, **b),
        lambda om, wmod: _fail_trace(om) + (
            om.TraceEvent(iteration=3, kind="fail", link=(3, 6)),), 5),
    "load-shift": ("job", lambda om, **b: om.ReoptPolicy.reactive(replan_latency=1e-3, **b),
                   lambda om, wmod: (om.TraceEvent(iteration=1, kind="load", job=wmod.VGG16),),
                   3),
    "churn-static": ("jobset", lambda om, **b: om.ReoptPolicy.never(), _churn_trace, 5),
    "churn-reactive": ("jobset", lambda om, **b: om.ReoptPolicy.reactive(
        replan_latency=1e-3, **b), _churn_trace, 5),
    "churn-placement": ("jobset", lambda om, **b: om.ReoptPolicy.reactive(
        replan_latency=1e-3, candidates=3, max_migrations=1, migration_restart=0.0, **b),
        _churn_trace, 5),
}


def _replay(om, wmod, hw, plans, name, **backend):
    driver, policy, trace, n_iters = REPLAYS[name]
    kw = dict(policy=policy(om, **backend), trace=trace(om, wmod), n_iters=n_iters, seed=0)
    if driver == "job":
        return om.run_online(wmod.DLRM, N, hw, plan=plans["dlrm"], **kw)
    return om.run_online_jobset(_jobset(wmod), hw, plan=plans["shared"], **kw)


@pytest.mark.parametrize("name", sorted(REPLAYS))
def test_numpy_replay_equals_reference_to_the_bit(plans, name):
    ref_plans, port_plans = plans
    want = _replay(ref_online, ref_wl, REF_HW, ref_plans, name)
    got = _replay(online, wl, HW, port_plans, name, **NUMPY)
    assert _run_view(got) == _run_view(want)
    if name not in ("static", "churn-static"):
        assert got.n_replans >= 1, "the case must replan to test the fork"


def _hysteresis_controller(om, wmod, hw, plan, **backend):
    ctrl = om.ReoptController(
        wmod.DLRM, N, hw=hw,
        policy=om.ReoptPolicy(on_failure=True, min_interval=10.0, replan_latency=1e-3,
                              **backend),
        plan=plan,
    )
    pauses = [ctrl.fail((0, 1), now=0.0), ctrl.fail((2, 5), now=0.5),
              ctrl.fail((3, 6), now=20.0)]
    return ctrl, pauses


def test_controller_hysteresis_equals_reference(plans):
    ref_plans, port_plans = plans
    want, want_p = _hysteresis_controller(ref_online, ref_wl, REF_HW, ref_plans["dlrm"])
    got, got_p = _hysteresis_controller(online, wl, HW, port_plans["dlrm"], **NUMPY)
    assert got.n_replans == want.n_replans == 2
    assert got_p == want_p and repr(got.log) == repr(want.log)
    assert got.dead == want.dead == {(0, 1), (2, 5), (3, 6)}
    assert _edges(got.topology) == _edges(want.topology)
    assert got.estimated_iter_time() == want.estimated_iter_time()


def test_jobset_controller_admit_depart_rebalance_equal_reference(plans):
    ref_plans, port_plans = plans

    def drive(om, wmod, hw, plan, **backend):
        ctrl = om.JobSetController(
            _jobset(wmod), hw=hw, plan=plan, seed=0,
            policy=om.ReoptPolicy.reactive(replan_latency=1e-3, candidates=3,
                                           max_migrations=1, migration_restart=0.0,
                                           **backend))
        admitted = ctrl.admit(wmod.VGG16, 2, name="vgg", now=1.0)
        pause = ctrl.depart("dlrm", now=2.0)
        return ctrl, admitted, pause

    want = drive(ref_online, ref_wl, REF_HW, ref_plans["shared"])
    got = drive(online, wl, HW, port_plans["shared"], **NUMPY)
    assert got[1:] == want[1:]
    assert repr(got[0].log) == repr(want[0].log)
    assert repr(got[0].migrations) == repr(want[0].migrations)
    assert _plan_view(got[0].plan) == _plan_view(want[0].plan)
    assert {t.label: t.servers for t in got[0].jobset.tenants} == {
        t.label: t.servers for t in want[0].jobset.tenants}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_placement_equals_reference(seed):
    rs = np.random.RandomState(seed)
    n = 16
    links = {}
    for _ in range(40):
        a, b = (int(v) for v in rs.randint(0, n, size=2))
        if a != b:
            links[(a, b)] = float(rs.choice([0.0, 1.0, 12.5e9, 25e9]))
    free = {int(v) for v in rs.choice(n, size=11, replace=False)}
    for k in (1, 3, 5):
        for hostable in (False, True):
            assert online.place_arrival(k, free, links, require_hostable=hostable) == \
                ref_online.place_arrival(k, free, links, require_hostable=hostable)
        assert online.place_candidates(k, free, links, n=5) == \
            ref_online.place_candidates(k, free, links, n=5)


def test_edge_churn_equals_reference(plans):
    ref_plans, port_plans = plans
    a, b = port_plans["dlrm"].topology, port_plans["shared"].topology
    ra, rb = ref_plans["dlrm"].topology, ref_plans["shared"].topology
    assert online.edge_churn(a, b) == ref_online.edge_churn(ra, rb) > 0
    assert online.edge_churn(a, a) == 0


# ---------------------------------------------------------------------------
# Torch on the CPU: the fused admission equals the JAX backend's
# ---------------------------------------------------------------------------


def _admit(om, wmod, hw, **backend):
    base = wmod.JobSet(n=16, tenants=[
        wmod.TenantJob(spec=wmod.DLRM, servers=tuple(range(0, 6)), weight=2.0, name="dlrm"),
    ])
    policy = dataclasses.replace(
        om.ReoptPolicy.reactive(replan_latency=0.0, rounds=1, mcmc_iters=15),
        chains=2, candidates=4, temperatures=(0.05, 0.1, 0.2, 0.4), **backend)
    ctrl = om.JobSetController(base, hw=hw, policy=policy, seed=2)
    out = ctrl.admit(wmod.BERT, 6, weight=1.0, name="bert", now=1.0)
    return ctrl, out


def test_admit_fused_torch_on_cpu_equals_jax_backend(monkeypatch):
    reached = []
    fused = alt._co_optimize_fused
    monkeypatch.setattr(alt, "_co_optimize_fused",
                        lambda *a, **k: reached.append(k["device"]) or fused(*a, **k))
    want_ctrl, want = _admit(ref_online, ref_wl, REF_HW, backend="jax")
    got_ctrl, got = _admit(online, wl, HW, backend="torch", device=CPU)
    assert reached == [CPU], "the admission must run the fused co-search"
    assert got == want and len(got[0]) == 6
    assert got_ctrl.plan.candidate_index == want_ctrl.plan.candidate_index
    assert _plan_view(got_ctrl.plan) == _plan_view(want_ctrl.plan)
    assert repr(got_ctrl.log) == repr(want_ctrl.log)
    assert "bert" in got_ctrl.plan.strategies
    assert not got_ctrl.plan_violations(got_ctrl.topology)
    repriced, _, _ = evaluate_jobset(got_ctrl.plan.strategies, got_ctrl.jobset,
                                     got_ctrl.plan.topology, HW)
    assert repriced == got_ctrl.plan.iter_time


def test_torch_replay_on_cpu_replans_and_is_repeatable(plans):
    """A reactive replay with the default backend, on the CPU: it plans on
    the torch chains (not the NumPy walk) and repeats to the bit."""
    _, port_plans = plans
    runs = [_replay(online, wl, HW, port_plans, "churn-reactive", device=CPU)
            for _ in range(2)]
    assert runs[0].n_replans >= 1
    assert _run_view(runs[0]) == _run_view(runs[1])


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------

_PAIRS = ((0, 1), (1, 2), (2, 3), (0, 3))


def _storm(fm, seed, **kw):
    domains = [fm.server_domain(1, _PAIRS, mtbf=15.0, mttr=3.0),
               fm.stride_domain(4, 1, mtbf=30.0, mttr=3.0)]
    kw.setdefault("link_mtbf", 10.0)
    return fm.FaultModel(n=4, links=_PAIRS, link_mttr=2.0, domains=domains, seed=seed, **kw)


def _failures(model, horizon):
    return [(f.time, f.link, f.repair_time) for f in model.link_failures(horizon)]


@pytest.mark.parametrize("seed", [0, 1, 5, 17])
@pytest.mark.parametrize("link_mtbf", [10.0, None])
def test_fault_streams_equal_reference(seed, link_mtbf):
    got, want = _storm(faults, seed, link_mtbf=link_mtbf), _storm(ref_faults, seed,
                                                                  link_mtbf=link_mtbf)
    assert got.outages(300.0) == want.outages(300.0)
    assert _failures(got, 300.0) == _failures(want, 300.0)
    assert repr(got.events(40, 2.5)) == repr(want.events(40, 2.5))
    assert got.events(40, 2.5)  # the storm is not empty


def _model(seed=0, **kw):
    kw.setdefault("link_mtbf", 10.0)
    kw.setdefault("link_mttr", 2.0)
    return faults.FaultModel(n=4, links=_PAIRS, seed=seed, **kw)


def _deterministic():
    a, b = _model(seed=5), _model(seed=5)
    assert a.link_failures(200.0) == b.link_failures(200.0)
    assert a.events(10, 5.0) == b.events(10, 5.0)
    assert _model(seed=6).link_failures(200.0) != a.link_failures(200.0)


def _merged_and_ordered():
    out = _model(seed=1, domains=[
        faults.server_domain(1, _PAIRS, mtbf=15.0, mttr=3.0)]).outages(500.0)
    assert out
    for pair, ivals in out.items():
        assert pair == (min(pair), max(pair))
        for (t0, t1), nxt in zip(ivals, ivals[1:] + [None]):
            assert 0.0 <= t0 < t1
            assert nxt is None or t1 < nxt[0], f"overlap on {pair}"


def _atomic_domain():
    dom = faults.server_domain(1, _PAIRS, mtbf=20.0, mttr=4.0)
    assert dom.links == ((0, 1), (1, 2))
    out = faults.FaultModel(n=4, links=(), link_mtbf=None, domains=[dom],
                            seed=2).outages(300.0)
    assert set(out) == {(0, 1), (1, 2)} and out[(0, 1)] == out[(1, 2)]


def _stable_substreams():
    plain = _model(seed=3).outages(300.0)
    with_dom = _model(seed=3, domains=[
        faults.server_domain(0, _PAIRS, mtbf=25.0, mttr=5.0)]).outages(300.0)
    assert plain[(1, 2)] == with_dom[(1, 2)] and plain[(2, 3)] == with_dom[(2, 3)]


def _events_alternate_and_heal():
    events = _model(seed=7, domains=[
        faults.stride_domain(4, 1, mtbf=30.0, mttr=3.0)]).events(40, 2.5)
    assert events and {ev.kind for ev in events} <= {"fail", "repair"}
    assert all(isinstance(ev, online.TraceEvent) for ev in events)
    state = {}
    for ev in events:
        assert state.get(ev.link, "repair") != ev.kind
        state[ev.link] = ev.kind
    assert all(kind == "repair" for kind in state.values())


def _validation():
    with pytest.raises(ValueError):
        faults.FaultModel(n=4, links=_PAIRS, link_mtbf=0.0)
    with pytest.raises(ValueError):
        faults.stride_domain(4, 4, mtbf=1.0, mttr=1.0)
    with pytest.raises(ValueError):
        faults.server_domain(9, _PAIRS, mtbf=1.0, mttr=1.0)
    with pytest.raises(ValueError):
        _model().events(4, 0.0)


FAULT_CASES = {"deterministic": _deterministic, "merged": _merged_and_ordered,
               "atomic-domain": _atomic_domain, "substreams": _stable_substreams,
               "events": _events_alternate_and_heal, "validation": _validation}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_fault_model_properties(case):
    FAULT_CASES[case]()


def test_for_topology_uses_live_pairs(plans):
    _, port_plans = plans
    topo = port_plans["dlrm"].topology
    fm = faults.FaultModel.for_topology(topo, link_mtbf=5.0)
    assert set(fm.links) == {(min(a, b), max(a, b)) for a, b in topo.graph.edges()}
    assert fm.n == topo.n


@pytest.fixture(scope="module")
def vgg_plans():
    return (ref_alt.alternating_optimize(ref_wl.VGG16, 8, REF_HW, rounds=1, mcmc_iters=10,
                                         seed=0),
            alt.alternating_optimize(wl.VGG16, 8, HW, rounds=1, mcmc_iters=10, seed=0,
                                     **NUMPY))


def _crash_storm(om, wmod, hw, plan, **backend):
    calls = []
    ctrl = om.ReoptController(
        wmod.VGG16, 8, hw=hw, plan=plan,
        policy=om.ReoptPolicy(on_failure=True, replan_latency=1e-3, min_interval=0.0,
                              replan_retries=1, retry_backoff=2.0, **backend))

    def boom(warm=True):
        calls.append(warm)
        raise RuntimeError("optimizer crashed")

    ctrl._run_optimizer = boom
    pairs = sorted({(min(a, b), max(a, b)) for a, b in ctrl.topology.graph.edges()})
    pauses = [ctrl.fail(pairs[0], now=0.0)]
    n_first = len(calls)
    pauses.append(ctrl.fail(pairs[1], now=0.5))  # inside the backoff window
    n_backoff = len(calls)
    pauses.append(ctrl.fail(pairs[2], now=3.0))
    return ctrl, pauses, (n_first, n_backoff, len(calls))


def test_optimizer_crash_storm_backs_off_as_reference(vgg_plans):
    ref_plan, port_plan = vgg_plans
    want = _crash_storm(ref_online, ref_wl, REF_HW, ref_plan)
    got = _crash_storm(online, wl, HW, port_plan, device=CPU)
    assert got[1:] == want[1:] and got[2] == (2, 2, 4)
    ctrl = got[0]
    assert ctrl.n_optimizer_errors == want[0].n_optimizer_errors == 4
    assert ctrl.n_replans == 0 and ctrl._backoff_until == pytest.approx(7.0)
    assert [r.trigger for r in ctrl.log] == [r.trigger for r in want[0].log]
    assert ctrl.log[2].trigger.endswith(":backoff")


def _slow_deadline(om, wmod, hw, plan, **backend):
    calls = []
    ctrl = om.ReoptController(
        wmod.VGG16, 8, hw=hw, plan=plan,
        policy=om.ReoptPolicy(on_failure=True, replan_latency=1e-3, min_interval=0.0,
                              replan_deadline=5e-3, replan_retries=1, **backend))
    healthy = ctrl.plan

    def slow(warm=True):
        calls.append(warm)
        time.sleep(0.02)  # always over the 5 ms deadline
        return healthy

    ctrl._run_optimizer = slow
    pair = sorted({(min(a, b), max(a, b)) for a, b in ctrl.topology.graph.edges()})[0]
    ctrl.fail(pair, now=0.0)
    return ctrl, len(calls)


def test_replan_deadline_discards_slow_attempts_as_reference(vgg_plans):
    ref_plan, port_plan = vgg_plans
    want, want_calls = _slow_deadline(ref_online, ref_wl, REF_HW, ref_plan)
    got, got_calls = _slow_deadline(online, wl, HW, port_plan, device=CPU)
    assert got_calls == want_calls == 2
    assert got.n_optimizer_errors == want.n_optimizer_errors == 1
    assert [r.trigger for r in got.log] == [r.trigger for r in want.log] == [
        "failure:deadline", "failure:invalid"]
    assert got.n_rejected_plans == 1 and got.n_replans == 0


# ---------------------------------------------------------------------------
# Scheduler and fabrics
# ---------------------------------------------------------------------------


def _records(mod, n_servers, placement, lookahead):
    jobs = [mod.JobRequest(jid=i, arrival_s=i * 300.0, n_servers=size, duration_s=dur)
            for i, (size, dur) in enumerate(
                [(16, 600.0), (8, 2000.0), (24, 100.0), (8, 50.0), (16, 900.0), (4, 10.0)])]
    recs = mod.simulate(n_servers, jobs, lookahead=lookahead, placement=placement)
    return [(r.req.jid, r.servers, r.provision_ready_s, r.start_s, r.end_s)
            for r in recs], mod.mean_queueing_overhead(recs)


def _arrival_fit(om, links):
    return lambda free, k: om.place_arrival(k, free, links)


@pytest.mark.parametrize("lookahead", [True, False])
@pytest.mark.parametrize("placement", ["first_fit", "contiguous", "place_arrival"])
def test_scheduler_records_equal_reference(placement, lookahead):
    n = 32
    if placement == "place_arrival":
        links = {(i, (i + s) % n): 12.5e9 for i in range(n) for s in (1, 5) if i % 7}
        got = _records(scheduler, n, _arrival_fit(online, links), lookahead)
        want = _records(ref_scheduler, n, _arrival_fit(ref_online, links), lookahead)
    else:
        got = _records(scheduler, n, placement, lookahead)
        want = _records(ref_scheduler, n, placement, lookahead)
    assert got == want


def test_scheduler_fits_and_constants_equal_reference():
    free = {0, 1, 2, 4, 5, 6, 9, 10, 11, 12, 20}
    for k in (1, 3, 4, 6, 9):
        assert scheduler.first_fit(free, k) == ref_scheduler.first_fit(free, k)
        assert scheduler.contiguous_fit(free, k) == ref_scheduler.contiguous_fit(free, k)
    assert (scheduler.FLIP_S, scheduler.PATCH_PANEL_RECONFIG_S) == (
        ref_scheduler.FLIP_S, ref_scheduler.PATCH_PANEL_RECONFIG_S)
    with pytest.raises(ValueError, match="placement"):
        scheduler.simulate(8, [scheduler.JobRequest(0, 0.0, 2, 1.0)],
                           placement=lambda free, k: (0, 0))


FABRICS = {
    "expander-16": lambda m: m.expander_topology(16, 4, seed=1),
    "expander-18": lambda m: m.expander_topology(18, 4, seed=3),
    "sipml-8": lambda m: m.sipml_ring_topology(8, 4),
    "sipml-16": lambda m: m.sipml_ring_topology(16, 2),
}


@pytest.mark.parametrize("name", sorted(FABRICS))
def test_fabrics_equal_reference(name):
    got, want = FABRICS[name](fabrics), FABRICS[name](ref_fabrics)
    assert _edges(got) == _edges(want)
    assert (got.n, got.degree, got.d_allreduce, got.d_mp) == (
        want.n, want.degree, want.d_allreduce, want.d_mp)
    demands = [
        (data_parallel_demand(got.n, 1e9), ref_dp_demand(want.n, 1e9)),
        (wl.job_demand(wl.DLRM, got.n), ref_wl.job_demand(ref_wl.DLRM, want.n)),
    ]
    for dem, ref_dem in demands:
        t = fabrics.generic_comm_time(got, dem, HW)
        assert t == ref_fabrics.generic_comm_time(want, ref_dem, REF_HW) and t > 0


def test_fabric_shapes():
    topo = fabrics.expander_topology(16, 4, seed=1)
    assert set(topo.out_degrees()) == {4}
    ring = fabrics.sipml_ring_topology(8, 4)
    assert ring.graph.has_edge(0, 1) and ring.graph.has_edge(0, 7)
    assert ring.graph.has_edge(0, 2) and ring.graph.has_edge(0, 6)
    assert not ring.graph.has_edge(0, 4)


# ---------------------------------------------------------------------------
# packetsim: the deprecated shim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["PROPAGATION_DELAY", "FlowSimVec", "SimResult", "Task"])
def test_packetsim_shims_warn_and_forward(name):
    with pytest.warns(DeprecationWarning, match="repro_torch.core.simengine"):
        legacy = getattr(packetsim, name)
    blessed = getattr(simengine, name)
    assert legacy is blessed or legacy == blessed


def test_packetsim_flowsim_links_of_and_unknown_names():
    with pytest.warns(DeprecationWarning):
        cls = packetsim.FlowSim
    assert issubclass(cls, simengine.FlowSimVec)
    with pytest.warns(DeprecationWarning):
        assert packetsim.FlowSim is cls  # the lazy class is built once
    g = nx.MultiDiGraph()
    g.add_edge(0, 1)
    g.add_edge(0, 1)
    with pytest.warns(DeprecationWarning):
        assert packetsim.links_of(g) == {(0, 1): 2.0}
    with pytest.raises(AttributeError):
        packetsim.definitely_not_a_thing
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        simengine.FlowSimVec, simengine.SimEngine  # the blessed names never warn


# ---------------------------------------------------------------------------
# Backend rules
# ---------------------------------------------------------------------------


def test_policy_backend_rules():
    pol = online.ReoptPolicy()
    assert (pol.backend, pol.device) == ("torch", None)
    assert online.ReoptPolicy.reactive().backend == "torch"
    for bad in ("jax", "tpu"):
        with pytest.raises(ValueError, match="torch"):
            online.ReoptPolicy(backend=bad)
        with pytest.raises(ValueError, match="torch"):
            dataclasses.replace(online.ReoptPolicy.reactive(), backend=bad)
    with pytest.raises(ValueError, match="backend='torch'"):
        online.ReoptPolicy(backend="numpy", temperatures=pt.DEFAULT_TEMPER_LADDER)
    online.ReoptPolicy(temperatures=pt.DEFAULT_TEMPER_LADDER, device=CPU)  # fine


def test_default_replan_needs_a_card(plans, monkeypatch):
    """Without a card a default policy raises where it would plan (cold
    start, guarded replan, rebalance) rather than planning on the CPU; a
    policy that never plans replays on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_plans = plans
    with pytest.raises(RuntimeError, match="CUDA"):
        online.run_online(wl.DLRM, N, HW, policy=online.ReoptPolicy.reactive(), n_iters=1)
    ctrl = online.ReoptController(wl.DLRM, N, hw=HW, plan=port_plans["dlrm"],
                                  policy=online.ReoptPolicy.reactive())
    with pytest.raises(RuntimeError, match="CUDA"):
        ctrl.fail((0, 1), now=0.0)
    assert ctrl.n_optimizer_errors == 0 and ctrl.n_replans == 0
    js_ctrl = online.JobSetController(_jobset(wl), hw=HW, plan=port_plans["shared"],
                                      policy=online.ReoptPolicy(max_migrations=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        js_ctrl.depart("bert", now=0.0)  # no departure trigger, but a rebalance
    static = online.run_online(wl.DLRM, N, HW, policy=online.ReoptPolicy.never(),
                               trace=_fail_trace(online), n_iters=3, plan=port_plans["dlrm"])
    assert static.n_replans == 0 and static.n_failures == 2


@pytest.mark.parametrize("backend,device", [("numpy", None), ("torch", CPU)])
def test_every_engine_names_the_policy_backend(plans, monkeypatch, backend, device):
    """The probe engine and both drivers' engines are built with the
    policy's backend and device; every fluid run goes through one of them."""
    _, port_plans = plans
    runs = []
    real = simengine.SimEngine.run

    def spy(self, *a, **k):
        runs.append((self.backend, self.device))
        return real(self, *a, **k)

    monkeypatch.setattr(simengine.SimEngine, "run", spy)
    pol = online.ReoptPolicy(replan_latency=1e-3, backend=backend, device=device)
    online.run_online(wl.DLRM, N, HW, policy=pol, trace=_fail_trace(online), n_iters=3,
                      plan=port_plans["dlrm"])
    online.run_online_jobset(_jobset(wl), HW, policy=pol, trace=_churn_trace(online, wl),
                             n_iters=3, plan=port_plans["shared"])
    assert len(runs) > 6 and set(runs) == {(backend, device)}
