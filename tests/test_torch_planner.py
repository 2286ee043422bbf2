"""The port's planner (``repro_torch.core``) against the JAX package's.

* **Forks are exact:** the NumPy modules forked into the port (TotientPerms,
  SelectPermutations, TopologyFinder, the plan evaluator, SimEngine, the
  NumPy MCMC and the alternating loop) give the reference's results to the
  bit on every paper job.
* **Pricing:** ``TorchPlanEvaluator`` on the CPU is held to the NumPy
  evaluator and to the JAX package's ``JaxPlanEvaluator`` within
  ``TORCH_EQUIV_RTOL`` (1e-9 relative; it is in fact bit-exact against
  NumPy), on healthy and degraded fabrics and multitenant unions,
  mirroring ``tests/test_planeval_jax.py``.
* **Chain programs:** ``TorchChainKernel.run`` / ``.run_grid`` make the
  sequential NumPy oracles' decisions index for index (energies at rtol
  1e-12), for both objectives, with latency steps, dummy padded links,
  degraded fabrics and singleton, odd and even ladders, mirroring
  ``tests/test_admission_fused.py``.
* **End to end:** ``mcmc_search``, ``mcmc_search_jobset``,
  ``alternating_optimize`` and ``co_optimize_jobset`` (sequential and
  fused) with ``backend="torch", device="cpu"`` return the JAX backend's
  plans and ``iter_time`` at the same seeds.
* **Validation:** backends, ladders, and ``device=None`` without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import alternating as ref_alt
from repro.core import planeval_jax as ref_pj
from repro.core import strategy_search as ref_ss
from repro.core import workloads as ref_wl
from repro.core.demand import data_parallel_demand as ref_dp_demand
from repro.core.netsim import HardwareSpec as RefHW
from repro.core.planeval import plan_evaluator as ref_plan_evaluator
from repro.core.select_perms import select_permutations as ref_select
from repro.core.simengine import SimEngine as RefSimEngine
from repro.core.topology_finder import (
    remove_pair as ref_remove_pair,
    topology_finder as ref_topology_finder,
)
from repro.core.totient import totient_perms as ref_totient_perms

from repro_torch.core import alternating as alt
from repro_torch.core import planeval_torch as pt
from repro_torch.core import strategy_search as ss
from repro_torch.core import workloads as wl
from repro_torch.core.demand import data_parallel_demand
from repro_torch.core.netsim import HardwareSpec
from repro_torch.core.planeval import plan_evaluator
from repro_torch.core.select_perms import select_permutations
from repro_torch.core.simengine import SimEngine
from repro_torch.core.topology_finder import remove_pair, topology_finder
from repro_torch.core.totient import totient_perms

torch.set_num_threads(2)  # several test processes share the cores

HW = HardwareSpec(link_bandwidth=12.5e9, degree=4)
REF_HW = RefHW(link_bandwidth=12.5e9, degree=4)
HW_LAT = HardwareSpec(link_bandwidth=12.5e9, degree=4, link_latency=2e-6)
N = 16
CPU = "cpu"
JOBS = sorted(wl.PAPER_JOBS)


def _edges(topo):
    return sorted(topo.graph.edges())


def _same_strategies(a: dict, b: dict) -> bool:
    return {k: repr(v) for k, v in a.items()} == {k: repr(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def topos():
    return (
        topology_finder(data_parallel_demand(N, 1e9), HW.degree),
        ref_topology_finder(ref_dp_demand(N, 1e9), REF_HW.degree),
    )


def _jobset(mod):
    return mod.JobSet(n=N, tenants=[
        mod.TenantJob(spec=mod.DLRM, servers=tuple(range(0, 6)), weight=2.0,
                      name="dlrm0"),
        mod.TenantJob(spec=mod.BERT, servers=tuple(range(6, 12)), weight=1.0,
                      name="bert0"),
        mod.TenantJob(spec=mod.MOE_16E, servers=tuple(range(12, 16)),
                      weight=0.5, name="moe0"),
    ])


def _candidates(mod, k: int):
    return [
        mod.JobSet(n=N, tenants=[
            mod.TenantJob(spec=mod.DLRM, weight=2.0, name="dlrm0",
                          servers=tuple((s + off) % N for s in range(0, 6))),
            mod.TenantJob(spec=mod.BERT, weight=1.0, name="bert0",
                          servers=tuple((s + off) % N for s in range(6, 12))),
        ])
        for off in range(k)
    ]


# ---------------------------------------------------------------------------
# The NumPy forks are exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [5, 12, 16, 70])
def test_totient_and_select_permutations_fork(k):
    ps, ref = totient_perms(range(k)), ref_totient_perms(range(k))
    assert repr(ps) == repr(ref)
    for d in (1, 2, 3):
        assert repr(select_permutations(ps, d)) == repr(ref_select(ref, d))


@pytest.mark.parametrize("name", JOBS)
def test_planner_forks_match_reference(name):
    job, ref_job = wl.PAPER_JOBS[name], ref_wl.PAPER_JOBS[name]
    assert repr(job) == repr(ref_job)
    pool = pt.strategy_pool(job, N, 6, seed=3)
    ref_pool = ref_pj.strategy_pool(ref_job, N, 6, seed=3)
    assert [repr(s) for s in pool] == [repr(s) for s in ref_pool]
    topo = topology_finder(pool[-1].demand(job, N), HW.degree)
    ref_topo = ref_topology_finder(ref_pool[-1].demand(ref_job, N), REF_HW.degree)
    assert _edges(topo) == _edges(ref_topo)
    assert repr(topo.rings) == repr(ref_topo.rings)
    ev, ref_ev = plan_evaluator(topo, HW), ref_plan_evaluator(ref_topo, REF_HW)
    for s, rs in zip(pool, ref_pool):
        assert ev.comm_time(s.demand(job, N)) == ref_ev.comm_time(rs.demand(ref_job, N))
    flops = job.flops_per_sample * job.batch_per_gpu * N
    assert SimEngine(HW, backend="numpy").iteration_time(
        topo, pool[1].demand(job, N), flops, 0.2) == (
        RefSimEngine(REF_HW).iteration_time(ref_topo, ref_pool[1].demand(ref_job, N),
                                            flops, 0.2))
    # The NumPy searches: same chain, same plan, to the bit.
    res = ss.mcmc_search(job, topo, HW, iters=25, seed=5, backend="numpy")
    ref = ref_ss.mcmc_search(ref_job, ref_topo, REF_HW, iters=25, seed=5)
    assert repr(res.strategy) == repr(ref.strategy)
    assert res.iter_time == ref.iter_time and res.history == ref.history
    plan = alt.alternating_optimize(job, N, HW, rounds=2, mcmc_iters=15, seed=1,
                                    backend="numpy")
    ref_plan = ref_alt.alternating_optimize(ref_job, N, REF_HW, rounds=2,
                                            mcmc_iters=15, seed=1)
    assert repr(plan.strategy) == repr(ref_plan.strategy)
    assert plan.iter_time == ref_plan.iter_time and plan.rounds == ref_plan.rounds
    assert _edges(plan.topology) == _edges(ref_plan.topology)


def test_numpy_jobset_search_and_coopt_fork():
    js, ref_js = _jobset(wl), _jobset(ref_wl)
    kw = dict(rounds=2, mcmc_iters=15, seed=2)
    plan = alt.co_optimize_jobset(js, HW, backend="numpy", **kw)
    ref_plan = ref_alt.co_optimize_jobset(ref_js, REF_HW, **kw)
    assert _same_strategies(plan.strategies, ref_plan.strategies)
    assert plan.iter_time == ref_plan.iter_time
    assert plan.per_job == ref_plan.per_job
    assert plan.per_job_comm == ref_plan.per_job_comm
    assert _edges(plan.topology) == _edges(ref_plan.topology)


# ---------------------------------------------------------------------------
# Batched pricing (mirrors tests/test_planeval_jax.py)
# ---------------------------------------------------------------------------


def _demands(pool_fn, job, count, seed):
    return [s.demand(job, N) for s in pool_fn(job, N, count, seed)]


@pytest.mark.parametrize("fab", ["healthy", "degraded"])
def test_batched_pricing_matches_numpy_and_jax(topos, fab):
    topo, ref_topo = topos
    if fab == "degraded":
        topo = remove_pair(remove_pair(topo, (0, 1)), (3, 7))
        ref_topo = ref_remove_pair(ref_remove_pair(ref_topo, (0, 1)), (3, 7))
    demands = _demands(pt.strategy_pool, wl.DLRM, 20, 7)
    demands += _demands(pt.strategy_pool, wl.MOE_16E, 10, 8)
    ref_demands = _demands(ref_pj.strategy_pool, ref_wl.DLRM, 20, 7)
    ref_demands += _demands(ref_pj.strategy_pool, ref_wl.MOE_16E, 10, 8)
    tev = pt.torch_plan_evaluator(topo, HW, CPU)
    times = tev.comm_times(demands)
    numpy_times = np.array([plan_evaluator(topo, HW).comm_time(d) for d in demands])
    jax_times = ref_pj.jax_plan_evaluator(ref_topo, REF_HW).comm_times(ref_demands)
    assert times.dtype == np.float64 and times.shape == numpy_times.shape
    for other in (numpy_times, jax_times):
        rel = np.abs(times - other) / np.maximum(np.abs(other), 1e-30)
        assert np.max(rel) <= pt.TORCH_EQUIV_RTOL
    # The rank-by-rank segment sums repeat NumPy's sequential scatters.
    assert np.array_equal(times, numpy_times)
    assert np.array_equal(tev.comm_times(demands), times)  # repeatable


def test_pricing_matches_on_multitenant_unions(topos):
    topo, ref_topo = topos
    js, ref_js = _jobset(wl), _jobset(ref_wl)
    unions, ref_unions = [], []
    for seed in range(5):
        pick = {t.label: pt.strategy_pool(t.spec, t.k, 6, seed=seed + 11)[seed % 6]
                for t in js.tenants}
        ref_pick = {t.label: ref_pj.strategy_pool(t.spec, t.k, 6, seed=seed + 11)[seed % 6]
                    for t in ref_js.tenants}
        unions.append(js.union_for(pick))
        ref_unions.append(ref_js.union_for(ref_pick))
    times = pt.TorchPlanEvaluator(topo, HW, CPU).comm_times(unions)
    ev = plan_evaluator(topo, HW)
    assert np.array_equal(times, [ev.comm_time(u) for u in unions])
    jax_times = ref_pj.jax_plan_evaluator(ref_topo, REF_HW).comm_times(ref_unions)
    np.testing.assert_allclose(times, jax_times, rtol=pt.TORCH_EQUIV_RTOL, atol=0)


def test_pricing_latency_term_and_empty_batch(topos):
    topo, _ = topos
    demands = _demands(pt.strategy_pool, wl.BERT, 4, 2)
    tev = pt.TorchPlanEvaluator(topo, HW_LAT, CPU)
    ev = plan_evaluator(topo, HW_LAT)
    assert np.array_equal(tev.comm_times(demands), [ev.comm_time(d) for d in demands])
    assert tev.comm_times([]).shape == (0,)


def test_pack_demand_reproduces_scatter(topos):
    topo, ref_topo = topos
    ev = plan_evaluator(topo, HW)
    d = ss.default_strategy(wl.DLRM).demand(wl.DLRM, N)
    ids, shares = pt.pack_demand(ev, d)
    loads = np.zeros(ev.n_links)
    np.add.at(loads, ids, shares)
    assert np.allclose(loads, ev.loads(d)[: loads.size], rtol=1e-12, atol=0.0)
    ref_ids, ref_shares = ref_pj.pack_demand(
        ref_plan_evaluator(ref_topo, REF_HW),
        ref_ss.default_strategy(ref_wl.DLRM).demand(ref_wl.DLRM, N),
    )
    assert np.array_equal(ids, ref_ids) and np.array_equal(shares, ref_shares)


def test_torch_evaluator_comm_keeps_tax(topos):
    topo, _ = topos
    d = ss.default_strategy(wl.DLRM).demand(wl.DLRM, N)
    out = pt.TorchPlanEvaluator(topo, HW, CPU).comm(d)
    ref = plan_evaluator(topo, HW).comm(d)
    assert out["bandwidth_tax"] == ref["bandwidth_tax"]
    assert out["comm_time"] == pytest.approx(ref["comm_time"], rel=pt.TORCH_EQUIV_RTOL)


def test_simengine_torch_backend(topos):
    topo, _ = topos
    d = data_parallel_demand(N, 1e9)
    ref = SimEngine(HW, backend="numpy").comm_time(topo, d)["comm_time"]
    got = SimEngine(HW, backend="torch", device=CPU).comm_time(topo, d)["comm_time"]
    assert got == pytest.approx(ref, rel=pt.TORCH_EQUIV_RTOL)


# ---------------------------------------------------------------------------
# Chain programs vs the sequential NumPy oracles
# ---------------------------------------------------------------------------


def _random_tables(seed, T=4, S=12, L=60):
    rs = np.random.RandomState(100 + seed)
    V = rs.rand(T, S, L) * 1e9
    V[V < 0.4e9] = 0.0  # sparse activity so the decomposition has structure
    caps = rs.rand(L) * 12.5e9 + 1e9
    comps = rs.rand(T) * 0.01
    weights = rs.rand(T) * 2.0 + 0.25
    steps = rs.randint(1, 9, size=(T, S)).astype(np.float64)
    return V, caps, comps, weights, steps


@pytest.mark.parametrize("latency", [0.0, 3e-3])
@pytest.mark.parametrize("objective", ["union", "decomposed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_kernel_matches_reference_chains(objective, seed, latency):
    V, caps, comps, weights, steps = _random_tables(seed)
    T, S, _ = V.shape
    K, iters, overlap = 6, 80, 0.3
    kw = dict(steps=steps, alpha=latency)
    kernel = pt.TorchChainKernel(V, caps, comps, weights, overlap=overlap,
                                 objective=objective, device=CPU, **kw)
    t_idx, s_idx, u = pt.draw_proposal_streams(seed, K, iters, T, S)
    temps = np.linspace(0.05, 0.5, K)
    init_a = np.zeros(T, dtype=np.int64)
    best_a, best_obj, hist = kernel.run(init_a, temps, t_idx, s_idx, u)
    ref = pt.run_chains_reference(V, caps, comps, weights, overlap, objective,
                                  init_a, temps, t_idx, s_idx, u, **kw)
    assert best_a.dtype == np.int64 and best_obj.dtype == hist.dtype == np.float64
    assert np.array_equal(best_a, ref[0])
    np.testing.assert_allclose(best_obj, ref[1], rtol=1e-12)
    np.testing.assert_allclose(hist, ref[2], rtol=1e-12)
    # On the CPU the energies are the oracle's to the bit.
    assert np.array_equal(hist, ref[2])
    # The forked oracle is the JAX package's oracle.
    jref = ref_pj.run_chains_reference(V, caps, comps, weights, overlap, objective,
                                       init_a, temps, t_idx, s_idx, u, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(ref, jref))


def _grid_fixture(seed, k_candidates=2, pool_size=8, dead=(), pad_cap=1.0, pad_to=32):
    """A small packed grid over shifted two-tenant candidates."""
    cands = _candidates(wl, k_candidates)
    init = {t.label: ss.default_strategy(t.spec) for t in cands[0].tenants}
    pools = [
        pt.strategy_pool(t.spec, t.k, pool_size, seed + i, init=init[t.label])
        for i, t in enumerate(cands[0].tenants)
    ]
    topos = []
    for js in cands:
        t = topology_finder(js.union_for(init), HW.degree, pack="per_node")
        for pair in dead:
            t = remove_pair(t, pair)
        topos.append(t)
    return pt.pack_jobset_grid(cands, topos, HW, pools, pad_cap=pad_cap, pad_to=pad_to)[:5]


@pytest.mark.parametrize("ladder", [1, 2, 3, 4])
@pytest.mark.parametrize("objective", ["union", "decomposed"])
@pytest.mark.parametrize("seed", [0, 17, 230])
def test_grid_kernel_matches_sequential_reference(seed, ladder, objective):
    """The fused grid replays C x K x M sequential cells — including on
    degraded fabrics — and one candidate sliced out replays its rows."""
    rng = np.random.default_rng(seed)
    dead = [tuple(sorted(rng.choice(N, 2, replace=False)))
            for _ in range(rng.integers(0, 3))]
    V, caps, comps, weights, _ = _grid_fixture(seed, dead=dead)
    C, T, S, L = V.shape
    K, iters = 2, 12
    temps = np.sort(rng.uniform(0.02, 0.5, size=ladder))
    t_idx, s_idx, u = pt.draw_grid_streams(seed, C, K, ladder, iters, T, S)
    su = pt.draw_swap_streams(seed, C, K, ladder, iters)
    init_a = rng.integers(0, S, size=(C, T))
    kern = pt.TorchChainKernel(V, caps, comps, weights, objective=objective, device=CPU)
    ba, bo, hist = kern.run_grid(init_a, temps, t_idx, s_idx, u, su)
    ra, ro, rhist = pt.run_grid_reference(V, caps, comps, weights, 0.0, objective, init_a,
                                          temps, t_idx, s_idx, u, su)
    assert np.array_equal(ba, ra)
    np.testing.assert_allclose(bo, ro, rtol=1e-12)
    np.testing.assert_allclose(hist, rhist, rtol=1e-12)
    solo = pt.TorchChainKernel(V[1:2], caps[1:2], comps, weights, objective=objective,
                               device=CPU)
    sa, so, _ = solo.run_grid(init_a[1:2], temps, t_idx[1:2], s_idx[1:2], u[1:2], su[1:2])
    assert np.array_equal(sa[0], ba[1]) and np.array_equal(so[0], bo[1])


@pytest.mark.parametrize("objective", ["union", "decomposed"])
def test_grid_kernel_with_latency_steps_and_odd_ladder(objective):
    V, caps, comps, weights, steps = _random_tables(3, T=3, S=10, L=40)
    C = 3
    Vg = np.stack([V * (1.0 + 0.1 * c) for c in range(C)])
    capsg = np.stack([caps] * C)
    ladder = np.array([0.03, 0.1, 0.3])
    t_idx, s_idx, u = pt.draw_grid_streams(4, C, 3, 3, 40, 3, 10)
    su = pt.draw_swap_streams(4, C, 3, 3, 40)
    init_a = np.zeros((C, 3), dtype=np.int64)
    kw = dict(steps=steps, alpha=2e-3)
    got = pt.TorchChainKernel(Vg, capsg, comps, weights, overlap=0.4, objective=objective,
                              device=CPU, **kw).run_grid(init_a, ladder, t_idx, s_idx, u, su)
    ref = pt.run_grid_reference(Vg, capsg, comps, weights, 0.4, objective, init_a, ladder,
                                t_idx, s_idx, u, su, **kw)
    assert np.array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-12)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-12)


@pytest.mark.parametrize("seed,pad_cap", [(0, 0.5), (41, 7.0), (300, 200.0)])
def test_dummy_links_never_contribute(seed, pad_cap):
    """Padding capacity is unobservable: results are bitwise invariant,
    device and reference."""
    V, caps, comps, weights, _ = _grid_fixture(seed, pad_cap=1.0)
    V2, caps2, _, _, _ = _grid_fixture(seed, pad_cap=pad_cap)
    assert np.array_equal(V, V2)
    C, T, S, L = V.shape
    rng = np.random.default_rng(seed)
    temps = np.array([0.05, 0.1, 0.3])
    t_idx, s_idx, u = pt.draw_grid_streams(seed, C, 2, 3, 10, T, S)
    su = pt.draw_swap_streams(seed, C, 2, 3, 10)
    init_a = rng.integers(0, S, size=(C, T))
    for objective in ("union", "decomposed"):
        r1 = pt.TorchChainKernel(V, caps, comps, weights, objective=objective,
                                 device=CPU).run_grid(init_a, temps, t_idx, s_idx, u, su)
        r2 = pt.TorchChainKernel(V2, caps2, comps, weights, objective=objective,
                                 device=CPU).run_grid(init_a, temps, t_idx, s_idx, u, su)
        assert all(np.array_equal(a, b) for a, b in zip(r1, r2))


def test_grid_device_outputs_and_dtypes():
    V, caps, comps, weights, _ = _grid_fixture(5)
    C, T, S, L = V.shape
    t_idx, s_idx, u = pt.draw_grid_streams(5, C, 2, 4, 6, T, S)
    su = pt.draw_swap_streams(5, C, 2, 4, 6)
    kern = pt.TorchChainKernel(V, caps, comps, weights, device=CPU)
    ba, bo, hist = kern.run_grid(np.zeros((C, T), dtype=np.int64),
                                 np.array(pt.DEFAULT_TEMPER_LADDER), t_idx, s_idx, u, su,
                                 device=True)
    assert isinstance(ba, torch.Tensor) and ba.dtype == torch.int64
    assert bo.dtype == hist.dtype == torch.float64
    assert tuple(hist.shape) == (C, 2, 7)
    # The winners feed the next round's start states as device tensors.
    again = kern.run_grid(ba[:, 0], np.array(pt.DEFAULT_TEMPER_LADDER), t_idx, s_idx, u, su)
    ref = pt.run_grid_reference(V, caps, comps, weights, 0.0, "union", ba[:, 0].numpy(),
                                np.array(pt.DEFAULT_TEMPER_LADDER), t_idx, s_idx, u, su)
    assert np.array_equal(again[0], ref[0])


def test_first_argmin_takes_the_first_of_ties():
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.5, 0.5, 0.5, 0.5], [2.0, 2.0, 1.0, 1.0]],
                     dtype=torch.float64)
    assert pt.first_argmin(x, dim=1).tolist() == [1, 0, 2]
    assert pt.first_argmin(x.T, dim=0).tolist() == [1, 0, 2]
    assert np.array_equal(pt.first_argmin(x, 1).numpy(), np.argmin(x.numpy(), axis=1))


# ---------------------------------------------------------------------------
# Ladder helpers
# ---------------------------------------------------------------------------


def test_ladder_helpers_fork():
    assert pt.check_temper_ladder([0.05, 0.1, 0.4]) == (0.05, 0.1, 0.4)
    for bad in [(), (0.2, 0.1), (0.0, 0.1), (float("nan"),)]:
        with pytest.raises(ValueError):
            pt.check_temper_ladder(bad)
    assert pt.DEFAULT_TEMPER_LADDER == ref_pj.DEFAULT_TEMPER_LADDER
    for args in [(9, 3, 20, 4, 8)]:
        assert all(np.array_equal(a, b) for a, b in zip(
            pt.draw_proposal_streams(*args), ref_pj.draw_proposal_streams(*args)))
    assert all(np.array_equal(a, b) for a, b in zip(
        pt.draw_grid_streams(9, 2, 3, 3, 20, 4, 8), ref_pj.draw_grid_streams(9, 2, 3, 3, 20, 4, 8)))
    assert np.array_equal(pt.draw_swap_streams(9, 2, 3, 4, 20),
                          ref_pj.draw_swap_streams(9, 2, 3, 4, 20))


# ---------------------------------------------------------------------------
# End to end: backend="torch" on the CPU replays backend="jax"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chains", [1, 4])
def test_torch_mcmc_search_matches_jax(topos, chains):
    topo, ref_topo = topos
    kw = dict(iters=60, seed=3, chains=chains, pool_size=16)
    res = ss.mcmc_search(wl.DLRM, topo, HW, backend="torch", device=CPU, **kw)
    ref = ref_ss.mcmc_search(ref_wl.DLRM, ref_topo, REF_HW, backend="jax", **kw)
    assert repr(res.strategy) == repr(ref.strategy)
    assert res.iter_time == ref.iter_time
    np.testing.assert_allclose(res.history, ref.history, rtol=pt.TORCH_EQUIV_RTOL)
    assert len(res.history) == 61


def test_torch_mcmc_search_singleton_ladder_matches_flat(topos):
    topo, _ = topos
    kw = dict(iters=60, seed=2, backend="torch", chains=3, pool_size=24, device=CPU)
    flat = ss.mcmc_search(wl.BERT, topo, HW, temperature=0.1, **kw)
    grid = ss.mcmc_search(wl.BERT, topo, HW, temperatures=(0.1,), **kw)
    assert repr(grid.strategy) == repr(flat.strategy)
    assert grid.iter_time == flat.iter_time
    np.testing.assert_allclose(grid.history, flat.history, rtol=1e-12)


@pytest.mark.parametrize("objective", ["union", "decomposed"])
def test_torch_jobset_search_matches_jax(topos, objective):
    topo, ref_topo = topos
    kw = dict(iters=50, seed=5, chains=3, pool_size=12, objective=objective)
    res = ss.mcmc_search_jobset(_jobset(wl), topo, HW, backend="torch", device=CPU, **kw)
    ref = ref_ss.mcmc_search_jobset(_jobset(ref_wl), ref_topo, REF_HW, backend="jax", **kw)
    assert _same_strategies(res.strategies, ref.strategies)
    assert res.iter_time == ref.iter_time and res.per_job == ref.per_job


def test_torch_jobset_ladder_with_latency_matches_jax():
    topo = topology_finder(data_parallel_demand(N, 1e9), HW.degree)
    ref_topo = ref_topology_finder(ref_dp_demand(N, 1e9), REF_HW.degree)
    ref_hw = RefHW(link_bandwidth=12.5e9, degree=4, link_latency=2e-6)
    kw = dict(iters=30, seed=4, chains=2, pool_size=10, temperatures=(0.05, 0.1, 0.3))
    res = ss.mcmc_search_jobset(_jobset(wl), topo, HW_LAT, backend="torch", device=CPU, **kw)
    ref = ref_ss.mcmc_search_jobset(_jobset(ref_wl), ref_topo, ref_hw, backend="jax", **kw)
    assert _same_strategies(res.strategies, ref.strategies)
    assert res.iter_time == ref.iter_time


@pytest.mark.parametrize("job", ["bert", "dlrm"])
def test_alternating_optimize_torch_matches_jax(job):
    kw = dict(rounds=2, mcmc_iters=30, seed=3, chains=2, pool_size=16)
    plan = alt.alternating_optimize(wl.PAPER_JOBS[job], N, HW, backend="torch", device=CPU,
                                    **kw)
    ref = ref_alt.alternating_optimize(ref_wl.PAPER_JOBS[job], N, REF_HW, backend="jax", **kw)
    assert repr(plan.strategy) == repr(ref.strategy)
    assert plan.iter_time == ref.iter_time and plan.rounds == ref.rounds
    assert _edges(plan.topology) == _edges(ref.topology)


def test_co_optimize_jobset_sequential_torch_matches_jax():
    kw = dict(rounds=2, mcmc_iters=20, seed=1, chains=2, pool_size=8)
    plan = alt.co_optimize_jobset(_jobset(wl), HW, backend="torch", device=CPU, **kw)
    ref = ref_alt.co_optimize_jobset(_jobset(ref_wl), REF_HW, backend="jax", **kw)
    assert _same_strategies(plan.strategies, ref.strategies)
    assert plan.iter_time == ref.iter_time and plan.per_job == ref.per_job
    assert _edges(plan.topology) == _edges(ref.topology)


@pytest.mark.parametrize("temperatures", [pt.DEFAULT_TEMPER_LADDER, (0.05, 0.1, 0.2)])
def test_fused_co_optimize_torch_matches_jax(temperatures):
    kw = dict(rounds=2, mcmc_iters=40, seed=3, chains=4, temperatures=temperatures)
    cands, ref_cands = _candidates(wl, 4), _candidates(ref_wl, 4)
    plan = alt.co_optimize_jobset(cands[0], HW, placement_candidates=cands, backend="torch",
                                  device=CPU, **kw)
    ref = ref_alt.co_optimize_jobset(ref_cands[0], REF_HW, placement_candidates=ref_cands,
                                     backend="jax", **kw)
    assert plan.candidate_index == ref.candidate_index
    assert _same_strategies(plan.strategies, ref.strategies)
    assert plan.iter_time == ref.iter_time and plan.per_job == ref.per_job
    np.testing.assert_allclose(plan.rounds, ref.rounds, rtol=pt.TORCH_EQUIV_RTOL)
    assert _edges(plan.topology) == _edges(ref.topology)
    assert plan.jobset is cands[plan.candidate_index]
    # The adopted number is a NumPy re-price, never device arithmetic.
    repriced, _, per_job = ss.evaluate_jobset(plan.strategies, plan.jobset, plan.topology, HW)
    assert repriced == plan.iter_time and per_job == plan.per_job


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def test_backend_validation(topos):
    topo, _ = topos
    js = _jobset(wl)
    for call in (
        lambda b: ss.mcmc_search(wl.DLRM, topo, HW, iters=2, backend=b),
        lambda b: ss.mcmc_search_jobset(js, topo, HW, iters=2, backend=b),
        lambda b: alt.alternating_optimize(wl.BERT, N, HW, rounds=1, mcmc_iters=2, backend=b),
        lambda b: alt.co_optimize_jobset(js, HW, rounds=1, mcmc_iters=2, backend=b),
        lambda b: SimEngine(HW, backend=b),
    ):
        for bad in ("jax", "tpu"):
            with pytest.raises(ValueError, match="torch"):
                call(bad)
    with pytest.raises(ValueError, match="torch"):
        ss.mcmc_search(wl.DLRM, topo, HW, chains=3, backend="numpy")  # needs torch
    with pytest.raises(ValueError, match="backend"):
        ss.mcmc_search(wl.BERT, topo, HW, iters=2, temperatures=(0.05, 0.1),
                       backend="numpy")
    with pytest.raises(ValueError):
        pt.TorchChainKernel(np.zeros((1, 2, 3)), np.ones(3), np.zeros(1), np.ones(1),
                            objective="nope", device=CPU)
    with pytest.raises(ValueError, match="grid caps"):
        pt.TorchChainKernel(np.zeros((2, 1, 2, 3)), np.ones(3), np.zeros(1), np.ones(1),
                            device=CPU)


def test_device_none_needs_a_card(topos, monkeypatch):
    """The entry points run on the card unless asked for the CPU: the
    default is ``backend="torch"`` with ``device=None``, and without a card
    every one of them raises instead of carrying on on the CPU or in
    NumPy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo, _ = topos
    js = _jobset(wl)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.TorchPlanEvaluator(topo, HW)
    with pytest.raises(RuntimeError, match="CUDA"):
        ss.mcmc_search(wl.BERT, topo, HW, iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ss.mcmc_search_jobset(js, topo, HW, iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        alt.alternating_optimize(wl.BERT, N, HW, rounds=1, mcmc_iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        alt.co_optimize_jobset(js, HW, rounds=1, mcmc_iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.TorchChainKernel(np.zeros((1, 2, 3)), np.ones(3), np.zeros(1), np.ones(1),
                            device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        SimEngine(HW).comm_time(topo, data_parallel_demand(N, 1e9))
    assert SimEngine(HW).backend == "torch"
    # The host NumPy walk stays one explicit argument away.
    assert dataclasses.is_dataclass(ss.mcmc_search(wl.BERT, topo, HW, iters=2,
                                                   backend="numpy"))
