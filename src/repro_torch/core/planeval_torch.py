"""The batched planner on the card: torch float64 port of the JAX package's
``core/planeval_jax.py`` (the planner's accelerator path).

:mod:`repro_torch.core.planeval` compiles a fixed
:class:`~repro_torch.core.topology_finder.Topology` into flat NumPy
structure arrays (link-id table, per-group ring-edge incidence, CSR route
cache) and prices one candidate demand per Python call.  This module moves
the arithmetic of that pricing, and the MCMC chains that consume it, onto a
torch device in float64:

* :func:`pack_demand` flattens one demand's pricing work into per-occurrence
  link ids and byte shares (AllReduce ring-edge occurrences first, then MP
  route hops: exactly the occurrences the NumPy ``np.add.at`` scatters
  walk);
* :class:`TorchPlanEvaluator` prices K demands in one batch: the
  occurrences are sorted on the host into (demand, link, AllReduce or MP)
  segments, and the device adds each segment's shares one rank at a time —
  the same additions in the same order as the NumPy evaluator's sequential
  scatters, with no float atomics, so the times equal the NumPy
  evaluator's to the bit and repeat to the bit;
* :class:`TorchChainKernel` runs K independent MCMC chains on the device
  over a pre-priced ``(tenants, pool, links)`` load-vector tensor: a chain
  state is one pool index per tenant, the chain axis (and in grid mode the
  candidate and tempering-rung axes) is a batch dimension, and the
  iterations are a Python loop of tensor steps (the JAX package's one
  ``lax.scan`` dispatch becomes a few dozen small launches a step).

**Numerics.**  Every chain objective is the NumPy oracle's
(:func:`_objective_reference`) arithmetic in the oracle's order: sums over
tenants are written out term by term (sequential for the ``axis=0`` sums,
NumPy's pairwise order for the 1-D weighted sum), the bottleneck max and
the divisions are exact, so chain energies equal the oracle's to the bit
on the CPU; on the card only ``exp`` in the acceptance test may differ in
the last place.  Every random draw (proposed tenant, proposed pool index,
acceptance uniform, swap uniform) is pre-drawn on the host with
``random.Random`` exactly as the JAX package draws it, so the chains here
are the JAX package's chains: :func:`run_chains_reference` and
:func:`run_grid_reference` replay them sequentially in NumPy, and the tests
hold the device chains to them index for index.  Because a chain explores a
*pre-priced pool* rather than proposing unbounded host subsets per step, it
is a documented different chain from ``backend="numpy"``.

Every entry point takes ``device``: ``None`` means the card
(:func:`repro_torch.compat.resolve_device`, which raises without one);
nothing falls back to the CPU or to NumPy.
"""

from __future__ import annotations

import math
import random
from typing import NamedTuple

import numpy as np
import torch

from ..compat import resolve_device
from .netsim import HardwareSpec
from .planeval import PlanEvaluator, plan_evaluator

__all__ = [
    "TORCH_EQUIV_RTOL",
    "DEFAULT_TEMPER_LADDER",
    "pack_demand",
    "TorchPlanEvaluator",
    "torch_plan_evaluator",
    "TorchChainKernel",
    "check_temper_ladder",
    "draw_proposal_streams",
    "draw_grid_streams",
    "draw_swap_streams",
    "first_argmin",
    "run_chains_reference",
    "run_grid_reference",
    "strategy_pool",
    "pack_jobset_grid",
    "torch_mcmc_search",
    "torch_mcmc_search_jobset",
]

# Decorrelates the pool-construction RNG from the per-chain proposal
# streams (both are seeded from the caller's one seed).
_POOL_SEED_OFFSET = 0x9E3779B9

# Decorrelates the tempering swap uniforms from the proposal streams: a
# singleton ladder draws no swap uniforms, so the proposal streams (and
# with them every pre-ladder golden) are untouched by the ladder's
# introduction.
_SWAP_SEED_OFFSET = 0x85EBCA6B

# Default parallel-tempering ladder (ascending; the coldest rung matches
# the historical single-chain temperature=0.05 regime, the hottest rung
# explores).
DEFAULT_TEMPER_LADDER = (0.05, 0.1, 0.2, 0.4)


def check_temper_ladder(temperatures) -> tuple[float, ...]:
    """Validate a tempering ladder: non-empty, positive finite, ascending.

    Returns the ladder as a float tuple.  Neighbor swap moves pair rung
    ``m`` with ``m + 1``, so the ladder must be sorted coldest-first for
    the swap acceptance rule to mean what parallel tempering means.
    """
    ladder = tuple(float(t) for t in temperatures)
    if not ladder:
        raise ValueError("temperature ladder must be non-empty")
    for t in ladder:
        if not math.isfinite(t) or t <= 0.0:
            raise ValueError(
                "ladder temperatures must be positive and finite"
            )
    if any(b < a for a, b in zip(ladder, ladder[1:])):
        raise ValueError("temperature ladder must be sorted ascending")
    return ladder


# The bar the port is held to against the NumPy evaluator: the JAX
# package's own JAX_EQUIV_RTOL.  The torch pricing repeats the NumPy
# additions in their order, so it meets the bar with all of it to spare
# (the tests find it bit-exact on the CPU).
TORCH_EQUIV_RTOL = 1e-9

_F64 = torch.float64
_I64 = torch.int64


# ---------------------------------------------------------------------------
# Demand packing: one demand -> flat (link ids, byte shares) scatter arrays
# ---------------------------------------------------------------------------


def _pack_occurrences(ev: PlanEvaluator, demand):
    """:func:`pack_demand`'s arrays plus the count of leading AllReduce
    occurrences (the NumPy evaluator sums AllReduce and MP shares into two
    vectors and adds them once; the device pricing does the same)."""
    pids, vals = ev._ensure_compiled(demand)
    ids_parts: list[np.ndarray] = []
    share_parts: list[np.ndarray] = []
    for g in demand.allreduce:
        entry = ev._group(g.members)
        if entry is None:
            continue
        ids, n_rings, k = entry
        per_link_total = 2.0 * (k - 1) / k * g.nbytes
        if per_link_total == 0.0:
            continue
        ids_parts.append(ids)
        share_parts.append(
            np.full(ids.size, per_link_total / n_rings, dtype=np.float64)
        )
    n_ar = sum(p.size for p in ids_parts)
    if pids.size:
        starts = ev._pair_start[pids]
        lens = ev._pair_len[pids]
        total = int(lens.sum())
        if total:
            seg_off = np.cumsum(lens) - lens
            idx = (
                np.arange(total, dtype=np.int64)
                - np.repeat(seg_off, lens)
                + np.repeat(starts, lens)
            )
            ids_parts.append(ev._mp_ids[idx])
            share_parts.append(
                np.repeat(vals / ev._pair_nroutes[pids], lens)
            )
    if not ids_parts:
        return (
            np.zeros(0, dtype=np.int64),
            np.zeros(0, dtype=np.float64),
            0,
        )
    return np.concatenate(ids_parts), np.concatenate(share_parts), n_ar


def pack_demand(ev: PlanEvaluator, demand) -> tuple[np.ndarray, np.ndarray]:
    """Flatten ``demand`` into per-occurrence ``(link_ids, shares)``.

    The occurrence stream is exactly what the NumPy evaluator scatters:
    AllReduce groups in demand order (each group's ring edges in reference
    walk order, share ``2(k-1)/k * nbytes / n_rings``), then MP entries in
    ``np.nonzero`` order (each pair's route hops, share
    ``bytes / n_routes``).

    Compiles lazily through the shared :class:`PlanEvaluator` caches — pack
    every demand of a batch *before* reading ``ev.n_links``/``ev.caps`` so
    the link universe stops growing first.
    """
    ids, shares, _ = _pack_occurrences(ev, demand)
    return ids, shares


class TorchPack(NamedTuple):
    """K demands' occurrences on the device, in fixed reduction order.

    ``seg[i]`` is occurrence ``i``'s segment ``(row * n_links + link) * 2 +
    kind`` (kind 0 AllReduce, 1 MP) and ``share[i]`` its bytes; the
    occurrences are ordered by their rank within their segment, then by
    segment, and ``bounds[j]:bounds[j + 1]`` holds rank ``j`` (so no
    segment appears twice in one rank)."""

    seg: torch.Tensor
    share: torch.Tensor
    bounds: tuple[int, ...]
    rows: int
    n_links: int


class TorchPlanEvaluator:
    """Batched demand pricing on a torch device: K candidates a call.

    Wraps the (memoized) NumPy :class:`PlanEvaluator` of the same topology:
    structure compilation (link ids, ring incidence, routes) stays on the
    host and is shared with every NumPy caller; the scatter and the
    bottleneck division run on ``device``.  The JAX package's
    ``segment_sum`` has no deterministic CUDA twin (``index_add_`` adds
    with float atomics), so :meth:`pack` sorts the occurrences on the host
    into (demand, link, kind) segments and :meth:`bottlenecks` adds them
    one rank at a time: rank ``j`` of every segment in one gather, add and
    indexed store, no segment twice in a rank.  That is NumPy's sequential
    ``np.add.at`` order, so the loads — and the times — equal the NumPy
    evaluator's to the bit, and two calls agree to the bit.
    """

    def __init__(self, topo, hw: HardwareSpec, device=None):
        self.device = resolve_device(device)
        self.ev = plan_evaluator(topo, hw)
        self.topo = topo
        self.hw = hw

    def pack(self, demands) -> TorchPack:
        """The K demands' occurrences, sorted into segments and ranks on the
        host and copied to the device (all compiled into the shared link
        universe first)."""
        packs = [_pack_occurrences(self.ev, d) for d in demands]
        L = self.ev.n_links
        segs, shares = [], []
        for row, (ids, sh, n_ar) in enumerate(packs):
            kind = np.ones(ids.size, dtype=np.int64)
            kind[:n_ar] = 0
            segs.append((row * L + ids) * 2 + kind)
            shares.append(sh)
        seg = np.concatenate(segs) if segs else np.zeros(0, dtype=np.int64)
        share = (
            np.concatenate(shares) if shares else np.zeros(0, dtype=np.float64)
        )
        # Stable: occurrences keep their scatter order within a segment.
        order = np.argsort(seg, kind="stable")
        seg, share = seg[order], share[order]
        first = np.ones(seg.size, dtype=bool)
        first[1:] = seg[1:] != seg[:-1]
        starts = np.flatnonzero(first)
        lens = np.diff(np.append(starts, seg.size))
        rank = np.arange(seg.size) - np.repeat(starts, lens)
        by_rank = np.argsort(rank, kind="stable")
        counts = np.bincount(rank) if rank.size else np.zeros(0, np.int64)
        bounds = tuple(int(b) for b in np.concatenate([[0], np.cumsum(counts)]))
        return TorchPack(
            seg=torch.from_numpy(seg[by_rank]).to(self.device),
            share=torch.from_numpy(share[by_rank]).to(self.device),
            bounds=bounds,
            rows=len(packs),
            n_links=L,
        )

    def bottlenecks(self, pk: TorchPack) -> torch.Tensor:
        """``(K,)`` bottleneck times ``max(loads / caps)`` on the device
        (no latency term)."""
        L = pk.n_links
        if not L:
            return torch.zeros(pk.rows, dtype=_F64, device=self.device)
        acc = torch.zeros(pk.rows * L * 2, dtype=_F64, device=self.device)
        for lo, hi in zip(pk.bounds[:-1], pk.bounds[1:]):
            idx = pk.seg[lo:hi]
            acc[idx] = acc[idx] + pk.share[lo:hi]
        acc = acc.view(pk.rows, L, 2)
        loads = acc[:, :, 0] + acc[:, :, 1]
        caps = torch.from_numpy(np.ascontiguousarray(self.ev.caps)).to(self.device)
        return (loads / caps).amax(dim=1)

    def comm_times(self, demands) -> np.ndarray:
        """Bottleneck comm times of K demands in one batch — equal to
        :meth:`PlanEvaluator.comm_time` per demand (held to
        :data:`TORCH_EQUIV_RTOL`)."""
        demands = list(demands)
        if not demands:
            return np.zeros(0)
        times = self.bottlenecks(self.pack(demands)).cpu().numpy()
        if self.hw.link_latency:
            from .demand import demand_steps

            times = times + self.hw.link_latency * np.asarray(
                [demand_steps(d) for d in demands]
            )
        return times

    def comm_time(self, demand) -> float:
        """Single-demand comm time through the batched pricing."""
        return float(self.comm_times([demand])[0])

    def comm(self, demand) -> dict[str, float]:
        """Drop-in for :meth:`PlanEvaluator.comm` with the comm time priced
        on the device (the bandwidth tax reuses the host route cache — it
        is a per-pair average, not a hot-loop quantity)."""
        out = self.ev.comm(demand)
        return {
            "comm_time": self.comm_time(demand),
            "bandwidth_tax": out["bandwidth_tax"],
        }


def torch_plan_evaluator(topo, hw: HardwareSpec, device=None) -> TorchPlanEvaluator:
    """Memoized :class:`TorchPlanEvaluator` per (topology, hw, device) —
    the torch analogue of :func:`~repro_torch.core.planeval.plan_evaluator`,
    sharing its host-side structure caches."""
    device = resolve_device(device)
    cache = getattr(topo, "_torch_planevals", None)
    if cache is None:
        cache = {}
        topo._torch_planevals = cache
    ev = cache.get((hw, device))
    if ev is None:
        ev = TorchPlanEvaluator(topo, hw, device)
        cache[(hw, device)] = ev
    return ev


# ---------------------------------------------------------------------------
# Strategy pool: the pre-priced move space of the device chains
# ---------------------------------------------------------------------------


def strategy_pool(
    job, n: int, size: int, seed: int, init=None, schedules=None
) -> list:
    """A deterministic pool of ``size`` candidate strategies for one job.

    Index 0 is the chain's start state (``init`` or the cold default); the
    rest come from a fixed-seed random walk of the NumPy proposal kernel
    (:func:`~repro_torch.core.strategy_search._propose`), deduplicated.  When the
    reachable space is smaller than ``size`` the pool is padded by cycling
    (duplicate entries are harmless: a move onto a duplicate prices
    identically to its twin).  ``schedules`` (a tuple of collective
    schedule names) widens the walk with schedule flips exactly as in the
    NumPy proposal kernel; ``None`` / single-entry keeps the walk (and its
    RNG stream) byte-identical to the pre-schedule pool.
    """
    from .strategy_search import _propose, default_strategy

    if size < 1:
        raise ValueError("strategy pool needs size >= 1")
    rng = random.Random(seed)
    current = init if init is not None else default_strategy(job)
    pool = [current]
    seen = {current}
    tries = 0
    while len(pool) < size and tries < 64 * size:
        cand = _propose(current, job, n, rng, schedules=schedules)
        tries += 1
        if cand not in seen:
            seen.add(cand)
            pool.append(cand)
        current = cand  # random-walk the space for coverage
    distinct = len(pool)
    while len(pool) < size:
        pool.append(pool[len(pool) % distinct])
    return pool


# ---------------------------------------------------------------------------
# Batched MCMC chains: K chains (x candidates x rungs) as batch dimensions
# ---------------------------------------------------------------------------


def draw_proposal_streams(
    seed: int, chains: int, iters: int, n_tenants: int, pool_size: int
):
    """Host-side randomness of K chains, pre-drawn and replayable.

    Chain ``c`` draws from ``random.Random(seed + c)`` in strict
    (tenant, pool index, acceptance uniform) per-iteration order — the
    exact stream :func:`run_chains_reference` replays sequentially, so the
    batched device run and the NumPy reference are the *same* chains.

    Returns ``(t_idx, s_idx, u)`` each of shape ``(chains, iters)``.
    """
    t_idx = np.zeros((chains, iters), dtype=np.int64)
    s_idx = np.zeros((chains, iters), dtype=np.int64)
    u = np.zeros((chains, iters), dtype=np.float64)
    for c in range(chains):
        rng = random.Random(seed + c)
        for i in range(iters):
            t_idx[c, i] = rng.randrange(n_tenants)
            s_idx[c, i] = rng.randrange(pool_size)
            u[c, i] = rng.random()
    return t_idx, s_idx, u


def draw_grid_streams(
    seed: int,
    candidates: int,
    chains: int,
    ladder: int,
    iters: int,
    n_tenants: int,
    pool_size: int,
):
    """:func:`draw_proposal_streams` lifted to the (candidate, temperature)
    grid: cell ``(ci, c, m)`` draws its own stream from
    ``random.Random(seed + c + _POOL_SEED_OFFSET * (ci * ladder + m))`` in
    the same strict (tenant, pool index, acceptance uniform) order.  The
    golden-ladder offset decorrelates cells while the degenerate cell
    ``(0, c, 0)`` reduces to exactly :func:`draw_proposal_streams`' chain
    ``c`` — the byte-identity anchor of the singleton-ladder contract.

    Returns ``(t_idx, s_idx, u)`` each of shape
    ``(candidates, chains, ladder, iters)``.
    """
    t_idx = np.zeros((candidates, chains, ladder, iters), dtype=np.int64)
    s_idx = np.zeros((candidates, chains, ladder, iters), dtype=np.int64)
    u = np.zeros((candidates, chains, ladder, iters), dtype=np.float64)
    for ci in range(candidates):
        for c in range(chains):
            for m in range(ladder):
                rng = random.Random(
                    seed + c + _POOL_SEED_OFFSET * (ci * ladder + m)
                )
                for i in range(iters):
                    t_idx[ci, c, m, i] = rng.randrange(n_tenants)
                    s_idx[ci, c, m, i] = rng.randrange(pool_size)
                    u[ci, c, m, i] = rng.random()
    return t_idx, s_idx, u


def draw_swap_streams(
    seed: int, candidates: int, chains: int, ladder: int, iters: int
) -> np.ndarray:
    """Pre-drawn swap-acceptance uniforms of the tempering ladder.

    One uniform per (iteration, neighbor pair) from a
    :data:`_SWAP_SEED_OFFSET`-shifted stream per (candidate, chain) — a
    singleton ladder has zero pairs and draws nothing, leaving the
    proposal streams byte-identical to the pre-ladder kernel.

    Returns shape ``(candidates, chains, iters, ladder // 2)``.
    """
    pairs = ladder // 2
    su = np.zeros((candidates, chains, iters, pairs), dtype=np.float64)
    for ci in range(candidates):
        for c in range(chains):
            rng = random.Random(
                seed + c + _SWAP_SEED_OFFSET + _POOL_SEED_OFFSET * ci
            )
            for i in range(iters):
                for p in range(pairs):
                    su[ci, c, i, p] = rng.random()
    return su


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first minimum along ``dim`` (the tie rule of
    ``np.argmin`` and ``jnp.argmin``), written out so that tied energies
    resolve the same way on every device."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ar = torch.arange(n, dtype=_I64, device=x.device).view(shape)
    return torch.where(x == x.amin(dim, keepdim=True), ar, n).amin(dim)


def _pairwise_sum(cols, lo: int, n: int):
    """NumPy's pairwise summation of ``cols[lo:lo + n]`` (elementwise over
    tensors), term for term: the order ``np.sum`` adds a contiguous 1-D
    float64 array in."""
    if n < 8:
        res = cols[lo]
        for i in range(lo + 1, lo + n):
            res = res + cols[i]
        return res
    if n <= 128:
        r = [cols[lo + j] for j in range(8)]
        i = 8
        while i < n - n % 8:
            r = [r[j] + cols[lo + i + j] for j in range(8)]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for j in range(i, n):
            res = res + cols[lo + j]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_sum(cols, lo, n2) + _pairwise_sum(cols, lo + n2, n - n2)


def _accept(cand, cur, temps, u):
    """The annealing rule in float64 on the host-drawn uniforms."""
    temp = temps * torch.clamp_min(cur, 1e-12)
    return (cand <= cur) | (u < torch.exp(-(cand - cur) / temp))


class TorchChainKernel:
    """K annealing chains over a pre-priced strategy pool, on a torch device.

    ``V[t, s, :]`` is tenant ``t``'s cluster-level link-load vector under
    pool strategy ``s`` (priced once on host by the bit-exact NumPy
    evaluator); a chain state is one pool index per tenant.  Each step
    re-prices the proposed states *from scratch* — gather T rows, sum, one
    bottleneck division — in the NumPy oracle's arithmetic and order, so
    chain objectives carry no incremental float lineage and the batched
    chains make the sequential NumPy reference's decisions.

    ``objective="union"`` anneals on the union bottleneck comm time (the
    historical jobset objective); ``objective="decomposed"`` anneals on the
    weighted per-tenant decomposed comm times
    (:func:`~repro_torch.core.strategy_search.tenant_comm_times` semantics:
    each tenant's own bytes under weighted processor sharing of every link
    it loads).

    **Grid mode** (``V.ndim == 4``): ``V[ci, t, s, :]`` stacks one load
    tensor per placement candidate, padded to the widest candidate's link
    table (dummy links carry zero load against ``caps[ci, pad:]``, so they
    can never win a bottleneck); ``caps`` becomes ``(C, L)``.  Each chain
    then carries a whole parallel-tempering ladder: every step applies the
    annealing rule to all ``M`` rungs at once, follows with a deterministic
    even/odd neighbor swap pass (Metropolis swap acceptance
    ``su < exp((1/T_lo - 1/T_hi) * (E_lo - E_hi))`` on pre-drawn host
    uniforms, iteration parity alternating the pairing), and tracks the
    per-(candidate, chain) best state across rungs — the whole
    (candidate x chain x rung) grid as batch dimensions of one program
    (:meth:`run_grid`).  The swap pass is a gather through a permutation of
    the rungs, so no two writes ever land on one element.  A singleton
    ladder performs no swap pass and replays the flat kernel's decisions
    exactly.

    All tensors live on ``device`` (the card when ``None``): float64
    values, int64 indices.
    """

    def __init__(
        self,
        V: np.ndarray,  # (T, S, L) load vectors; (C, T, S, L) = grid mode
        caps: np.ndarray,  # (L,); (C, L) in grid mode
        comps: np.ndarray,  # (T,) per-tenant compute times
        weights: np.ndarray,  # (T,) tenant weights
        overlap: float = 0.0,
        objective: str = "union",
        steps: np.ndarray | None = None,  # (T, S) latency rounds per entry
        alpha: float = 0.0,  # per-round link latency (hw.link_latency)
        device=None,
    ):
        if objective not in ("union", "decomposed"):
            raise ValueError(f"unknown chain objective {objective!r}")
        self.device = dev = resolve_device(device)
        self.objective = objective
        V = np.asarray(V, dtype=np.float64)
        caps = np.asarray(caps, dtype=np.float64)
        self.grid = V.ndim == 4
        if self.grid:
            C, T, S, L = V.shape
            if caps.shape != (C, L):
                raise ValueError(
                    f"grid caps must have shape {(C, L)}, got {caps.shape}"
                )
            self.grid_shape = (C, T, S, L)
        else:
            T, S, L = V.shape
        self.shape = (T, S, L)
        f64 = dict(dtype=_F64, device=dev)
        self._V = torch.as_tensor(V.reshape(-1, L), **f64)
        caps_t = torch.as_tensor(caps, **f64)
        self._comps = torch.as_tensor(np.asarray(comps), **f64)
        w = torch.as_tensor(np.asarray(weights), **f64)
        self._w = w
        self._total_w = float(np.sum(weights))
        self._overlap = float(overlap)
        self._alpha = float(alpha)
        self._steps = (
            torch.as_tensor(np.asarray(steps).reshape(-1), **f64)
            if steps is not None and self._alpha
            else None
        )
        t_off = torch.arange(T, dtype=_I64, device=dev) * S
        self._step_base = t_off  # row of (t, a_t) in the flattened (T*S) table
        w_col = w[:, None]
        self._w_col = w_col
        if self.grid:
            c_off = torch.arange(C, dtype=_I64, device=dev) * (T * S)
            self._base = (c_off[:, None] + t_off[None, :]).view(C, 1, 1, T)
            self._caps = caps_t.view(C, 1, 1, L)
            self._wcaps = (w_col[None] * caps_t[:, None, :]).view(C, 1, 1, T, L)
        else:
            self._base = t_off
            self._caps = caps_t
            self._wcaps = w_col * caps_t[None, :]

    def energies(self, A: torch.Tensor) -> torch.Tensor:
        """Objectives of a batch of states ``A`` (..., T) -> (...): the
        arithmetic of :func:`_objective_reference`, in its order."""
        T = self.shape[0]
        rows = self._V[self._base + A]  # (..., T, L)
        steps = (
            self._steps[self._step_base + A] if self._steps is not None else None
        )
        if self.objective == "union":
            tot = rows[..., 0, :]
            for t in range(1, T):
                tot = tot + rows[..., t, :]
            comm = (tot / self._caps).amax(dim=-1)
            if steps is not None:
                # Union latency rounds = the worst tenant's rounds.
                comm = comm + self._alpha * steps.amax(dim=-1)
            comm_t = comm.unsqueeze(-1).expand(*comm.shape, T)
        else:
            active = rows > 0.0
            wa = torch.where(active, self._w_col, 0.0)
            active_w = wa[..., 0, :]  # contending weight per link
            for t in range(1, T):
                active_w = active_w + wa[..., t, :]
            per = torch.where(
                active, rows * active_w.unsqueeze(-2) / self._wcaps, 0.0
            )
            comm_t = per.amax(dim=-1)
            if steps is not None:
                comm_t = comm_t + self._alpha * steps
        hidden = torch.minimum(comm_t * self._overlap, self._comps)
        weighted = self._w * (self._comps + comm_t - hidden)
        total = _pairwise_sum([weighted[..., t] for t in range(T)], 0, T)
        return total / self._total_w

    def run(
        self,
        init_a: np.ndarray,  # (T,) shared start state
        temperatures: np.ndarray,  # (K,) per-chain temperature
        t_idx: np.ndarray,  # (K, iters)
        s_idx: np.ndarray,
        u: np.ndarray,
    ):
        """All K chains as one batch.  Returns ``(best_assignments (K, T),
        best_objs (K,), history (K, iters+1))`` as NumPy arrays."""
        if self.grid:
            raise ValueError("grid-mode TorchChainKernel runs via run_grid()")
        dev = self.device
        K, iters = np.shape(t_idx)
        T = self.shape[0]
        ti, si, ui = self._streams(t_idx, s_idx, u)
        temps = torch.as_tensor(np.asarray(temperatures), dtype=_F64, device=dev)
        a = torch.as_tensor(np.asarray(init_a), dtype=_I64, device=dev)
        a = a.expand(K, T).contiguous()
        cur = self.energies(a)
        best_a, best = a, cur
        hist = torch.empty(iters + 1, K, dtype=_F64, device=dev)
        hist[0] = cur
        for i in range(iters):
            cand_a = a.scatter(1, ti[i].unsqueeze(1), si[i].unsqueeze(1))
            cand = self.energies(cand_a)
            accept = _accept(cand, cur, temps, ui[i])
            better = accept & (cand < best)
            a = torch.where(accept[:, None], cand_a, a)
            cur = torch.where(accept, cand, cur)
            best_a = torch.where(better[:, None], cand_a, best_a)
            best = torch.where(better, cand, best)
            hist[i + 1] = cur
        return (
            best_a.cpu().numpy(),
            best.cpu().numpy(),
            hist.T.cpu().numpy(),
        )

    def _streams(self, *arrays):
        """Pre-drawn streams with the iteration axis moved first, on the
        device, so step ``i`` reads a contiguous slice."""
        return [
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0))).to(self.device)
            for a in arrays
        ]

    def _swap_tables(self, temps: np.ndarray):
        """Per parity: the identity permutation of the rungs, each rung's
        partner (itself when unpaired), its pair index and whether it has a
        valid pair, and the pairs' clipped (lo, hi) rungs, validity and
        inverse-temperature differences — the even/odd pairing of
        :func:`_swap_pass_reference`."""
        M = temps.size
        P = M // 2
        tables = []
        for par in (0, 1):
            lo = 2 * np.arange(P) + par
            hi = lo + 1
            valid = hi < M
            lo_c = np.minimum(lo, M - 1)
            hi_c = np.minimum(hi, M - 1)
            dinv = 1.0 / temps[lo_c] - 1.0 / temps[hi_c]
            partner = np.arange(M)
            pair_of = np.zeros(M, dtype=np.int64)
            has_pair = np.zeros(M, dtype=bool)
            for p in np.flatnonzero(valid):
                partner[lo[p]], partner[hi[p]] = hi[p], lo[p]
                pair_of[lo[p]] = pair_of[hi[p]] = p
                has_pair[lo[p]] = has_pair[hi[p]] = True
            tables.append(tuple(
                torch.from_numpy(x).to(self.device)
                for x in (np.arange(M), partner, pair_of, has_pair, lo_c, hi_c,
                          valid, dinv)
            ))
        return tables

    def run_grid(
        self,
        init_a,  # (C, T) per-candidate start states (NumPy or a device tensor)
        temperatures: np.ndarray,  # (M,) ascending tempering ladder
        t_idx: np.ndarray,  # (C, K, M, iters)
        s_idx: np.ndarray,
        u: np.ndarray,
        swap_u: np.ndarray,  # (C, K, iters, M // 2)
        device: bool = False,
    ):
        """The whole (candidate x chain x rung) grid as one batch.

        Returns ``(best_assignments (C, K, T), best_objs (C, K),
        history (C, K, iters + 1))`` — history is the running
        min-over-rungs objective.  ``device=True`` returns the device
        tensors so callers (the fused alternating loop) can hand the winner
        indices straight back into the next round without a host
        round-trip.
        """
        if not self.grid:
            raise ValueError("flat TorchChainKernel runs via run()")
        dev = self.device
        C, K, M, iters = np.shape(t_idx)
        T = self.shape[0]
        temps_np = np.asarray(temperatures, dtype=np.float64)
        temps = torch.from_numpy(temps_np).to(dev)
        ti, si, ui, sui = self._streams(t_idx, s_idx, u, np.moveaxis(swap_u, 2, 3))
        tables = self._swap_tables(temps_np) if M // 2 else None
        init = torch.as_tensor(init_a, dtype=_I64, device=dev)
        A = init[:, None, None, :].expand(C, K, M, T).contiguous()

        def take(A, m):  # A[c, k, m[c, k]] -> (C, K, T)
            return A.gather(2, m[:, :, None, None].expand(C, K, 1, T)).squeeze(2)

        cur = self.energies(A)
        m0 = first_argmin(cur, dim=2)
        best_a = take(A, m0)
        best = cur.gather(2, m0[..., None]).squeeze(2)
        hist = torch.empty(iters + 1, C, K, dtype=_F64, device=dev)
        hist[0] = best
        for i in range(iters):
            # Per-rung annealing move (each rung mutates its own row).
            cand_A = A.scatter(3, ti[i].unsqueeze(3), si[i].unsqueeze(3))
            cand = self.energies(cand_A)
            accept = _accept(cand, cur, temps, ui[i])
            A = torch.where(accept[..., None], cand_A, A)
            cur = torch.where(accept, cand, cur)
            if tables is not None:
                # Even/odd neighbor swap pass: parity alternates the
                # pairing; a clipped last pair (odd ladder) never swaps.
                ident, partner, pair_of, has_pair, lo_c, hi_c, valid, dinv = (
                    tables[i % 2]
                )
                delta = dinv * (cur[..., lo_c] - cur[..., hi_c])
                sw = valid & (sui[i] < torch.exp(delta))
                perm = torch.where(sw[..., pair_of] & has_pair, partner, ident)
                A = A.gather(2, perm[..., None].expand(C, K, M, T))
                cur = cur.gather(2, perm)
            m_star = first_argmin(cur, dim=2)
            step_best = cur.gather(2, m_star[..., None]).squeeze(2)
            better = step_best < best
            best = torch.where(better, step_best, best)
            best_a = torch.where(better[..., None], take(A, m_star), best_a)
            hist[i + 1] = step_best
        hist = hist.permute(1, 2, 0)
        if device:
            return best_a, best, hist
        return best_a.cpu().numpy(), best.cpu().numpy(), hist.cpu().numpy()


def _objective_reference(
    V: np.ndarray,
    caps: np.ndarray,
    comps: np.ndarray,
    weights: np.ndarray,
    overlap: float,
    objective: str,
    a: np.ndarray,
    steps: np.ndarray | None = None,
    alpha: float = 0.0,
) -> float:
    """NumPy mirror of :class:`TorchChainKernel`'s device objective."""
    T = V.shape[0]
    rows = V[np.arange(T), a]
    if objective == "union":
        comm = np.max(rows.sum(axis=0) / caps)
        if steps is not None and alpha:
            comm = comm + alpha * np.max(steps[np.arange(T), a])
        comm_t = np.full(T, comm)
    else:
        active = rows > 0.0
        active_w = np.where(active, weights[:, None], 0.0).sum(axis=0)
        per = np.where(
            active,
            rows * active_w[None, :] / (weights[:, None] * caps[None, :]),
            0.0,
        )
        comm_t = per.max(axis=1)
        if steps is not None and alpha:
            comm_t = comm_t + alpha * steps[np.arange(T), a]
    hidden = np.minimum(comm_t * overlap, comps)
    iters_t = comps + comm_t - hidden
    return float(np.sum(weights * iters_t) / np.sum(weights))


def _run_cell_or_grid(
    V, caps, comps, weights, overlap, objective, steps, alpha,
    seed, chains, iters, T, S, temperature, temperatures, device,
):
    """Dispatch one jobset search: the flat K-chain kernel when no ladder
    is requested, the C=1 grid kernel under a tempering ladder.  Returns
    ``(best_a (K', T), best_obj (K',), hist (K', iters + 1))`` with the
    grid's candidate axis squeezed away."""
    if temperatures is None:
        kernel = TorchChainKernel(
            V, caps, comps, weights, overlap=overlap, objective=objective,
            steps=steps, alpha=alpha, device=device,
        )
        t_idx, s_idx, u = draw_proposal_streams(seed, chains, iters, T, S)
        return kernel.run(
            np.zeros(T, dtype=np.int64),
            np.full(chains, temperature, dtype=np.float64),
            t_idx, s_idx, u,
        )
    ladder = np.asarray(check_temper_ladder(temperatures), dtype=np.float64)
    M = ladder.size
    kernel = TorchChainKernel(
        V[None], np.asarray(caps, dtype=np.float64)[None], comps, weights,
        overlap=overlap, objective=objective, steps=steps, alpha=alpha,
        device=device,
    )
    t_idx, s_idx, u = draw_grid_streams(seed, 1, chains, M, iters, T, S)
    su = draw_swap_streams(seed, 1, chains, M, iters)
    best_a, best_obj, hist = kernel.run_grid(
        np.zeros((1, T), dtype=np.int64), ladder, t_idx, s_idx, u, su,
    )
    return best_a[0], best_obj[0], hist[0]


def torch_mcmc_search(
    job,
    topo,
    hw: HardwareSpec,
    iters: int = 200,
    temperature: float = 0.1,
    overlap: float = 0.0,
    seed: int = 0,
    init=None,
    chains: int = 1,
    pool_size: int = 64,
    schedules=None,
    temperatures=None,
    device=None,
):
    """Batched single-job strategy search — the ``backend="torch"`` body of
    :func:`~repro_torch.core.strategy_search.mcmc_search`.

    The pool's load vectors are priced once on host by the bit-exact
    evaluator; all ``chains`` annealing chains then run as one batch on
    ``device`` (:class:`TorchChainKernel` with one tenant).  The winning
    strategy's reported ``iter_time`` is re-priced on the NumPy path, so
    result values carry no device float lineage; ``history`` is the best
    chain's device objective trace.  ``schedules`` widens the pool with
    collective-schedule flips; with ``hw.link_latency`` set the chains
    anneal on the same (α, β) objective the NumPy path prices.

    ``temperatures`` replaces the single ``temperature`` with a
    parallel-tempering ladder run through the grid kernel — a singleton
    ladder ``(t,)`` replays the flat ``temperature=t`` chains' decisions
    exactly (same proposal streams, no swap draws).
    """
    from .demand import demand_steps
    from .netsim import _iteration_time as iteration_time, compute_time
    from .strategy_search import SearchResult

    n = topo.n
    pool = strategy_pool(
        job, n, pool_size, seed + _POOL_SEED_OFFSET, init=init,
        schedules=schedules,
    )
    ev = plan_evaluator(topo, hw)
    demands = [s.demand(job, n) for s in pool]
    vecs = [ev.loads(d) for d in demands]  # grows the link universe
    L = ev.n_links
    S = len(pool)
    V = np.zeros((1, S, max(L, 1)), dtype=np.float64)
    for s, v in enumerate(vecs):
        V[0, s, : v.size] = v
    caps = ev.caps if L else np.ones(1)
    comp = compute_time(job.flops_per_sample * job.batch_per_gpu * n, n, hw)
    steps = (
        np.asarray([[demand_steps(d) for d in demands]], dtype=np.float64)
        if hw.link_latency
        else None
    )
    best_a, best_obj, hist = _run_cell_or_grid(
        V, caps, np.array([comp]), np.array([1.0]), overlap, "union",
        steps, hw.link_latency, seed, chains, iters, 1, S,
        temperature, temperatures, device,
    )
    c = int(np.argmin(best_obj))
    strategy = pool[int(best_a[c, 0])]
    demand = demands[int(best_a[c, 0])]
    iter_time = iteration_time(ev.comm_time(demand), comp, overlap=overlap)
    return SearchResult(
        strategy=strategy, iter_time=iter_time, demand=demand,
        history=[float(h) for h in hist[c]],
    )


def torch_mcmc_search_jobset(
    jobset,
    topo,
    hw: HardwareSpec,
    iters: int = 200,
    temperature: float = 0.1,
    overlap: float = 0.0,
    seed: int = 0,
    init=None,
    chains: int = 1,
    pool_size: int = 64,
    objective: str = "union",
    demand_cache=None,
    schedules=None,
    temperatures=None,
    device=None,
):
    """Batched multi-tenant strategy search — the ``backend="torch"`` body
    of :func:`~repro_torch.core.strategy_search.mcmc_search_jobset`.

    Per tenant, a pool of ``pool_size`` candidate strategies is priced once
    into cluster-level link-load vectors (through the incremental
    evaluator's caches, so repeat pricings are shared with the NumPy path);
    ``chains`` chains of per-tenant pool moves then anneal as one batch on
    ``device`` under the requested objective.  The winner's reported
    ``iter_time``/``per_job`` are re-priced on the bit-exact NumPy path
    (union) or the reference decomposition (decomposed).

    ``temperatures`` swaps the single ``temperature`` for a
    parallel-tempering ladder through the grid kernel; the singleton
    ladder replays the flat kernel's decisions exactly.
    """
    from .netsim import compute_time
    from .planeval import JobSetEvaluator, LRUCache
    from .strategy_search import (
        JobSetSearchResult,
        demand_cache_size,
        default_strategy,
        evaluate_jobset,
        evaluate_jobset_decomposed,
    )

    if not jobset.tenants:
        raise ValueError("torch_mcmc_search_jobset needs at least one tenant")
    if demand_cache is None:
        demand_cache = LRUCache(demand_cache_size())
    jse = JobSetEvaluator(
        jobset, topo, hw, overlap=overlap, demand_cache=demand_cache
    )
    tenants = jobset.tenants
    T = len(tenants)
    init = init or {}
    pools = []
    for i, t in enumerate(tenants):
        start = init.get(t.label) or default_strategy(t.spec)
        pools.append(strategy_pool(
            t.spec, t.k, pool_size, seed + _POOL_SEED_OFFSET + i,
            init=start, schedules=schedules,
        ))
    # Price every pool entry first (the link universe grows as new MP
    # routes are compiled), then pad all vectors to the final width.
    vecs = [
        [jse.tenant_loads_at(t.label, s, t.servers) for s in pools[i]]
        for i, t in enumerate(tenants)
    ]
    L = jse.ev.n_links
    S = pool_size
    V = np.zeros((T, S, max(L, 1)), dtype=np.float64)
    for i in range(T):
        for s, v in enumerate(vecs[i]):
            V[i, s, : v.size] = v
    caps = jse.ev.caps if L else np.ones(1)
    comps = np.array([
        compute_time(t.flops_per_iteration, t.k, hw) for t in tenants
    ])
    weights = np.array([t.weight for t in tenants], dtype=np.float64)
    steps = None
    if hw.link_latency:
        # Per-(tenant, pool entry) latency rounds of the tenant's *local*
        # embedded demand — union rounds are the max over tenants, which
        # the kernel's union objective takes per chain state.
        steps = np.asarray([
            [jse._steps(t.label, s) for s in pools[i]]
            for i, t in enumerate(tenants)
        ], dtype=np.float64)
    best_a, best_obj, hist = _run_cell_or_grid(
        V, caps, comps, weights, overlap, objective, steps,
        hw.link_latency, seed, chains, iters, T, S,
        temperature, temperatures, device,
    )
    c = int(np.argmin(best_obj))
    best = {
        t.label: pools[i][int(best_a[c, i])] for i, t in enumerate(tenants)
    }
    if objective == "decomposed":
        obj, per_job = evaluate_jobset_decomposed(
            best, jobset, topo, hw, overlap, _demand_cache=demand_cache
        )
        union = jse.union_for(best)
    else:
        obj, union, per_job = evaluate_jobset(
            best, jobset, topo, hw, overlap,
            _demand_cache=demand_cache, compiled=True,
        )
    return JobSetSearchResult(
        strategies=best, iter_time=obj, demand=union, per_job=per_job,
        history=[float(h) for h in hist[c]],
    )


def pack_jobset_grid(
    candidates,  # list[JobSet]: same tenants, different placements
    topos,  # list[Topology], one search topology per candidate
    hw: HardwareSpec,
    pools,  # list[list[Strategy]], one pre-built pool per tenant
    overlap: float = 0.0,
    demand_cache=None,
    pad_cap: float = 1.0,
    pad_to: int = 32,
):
    """Stack per-candidate pool pricings into the padded grid tensors.

    Each candidate's pool entries are priced on its own topology through
    the incremental :class:`~repro_torch.core.planeval.JobSetEvaluator` (one
    shared per-tenant demand cache serves all candidates — job-local
    demands are placement-independent), then every candidate's link table
    is padded to the widest one: dummy links carry zero load against
    capacity ``pad_cap``, so they can never win a bottleneck max nor
    activate in the decomposed objective, whatever ``pad_cap > 0`` is.

    ``pad_to`` additionally rounds the link axis up to a bucket multiple
    so the grid shape repeats across alternating rounds (and admissions of
    similar size).

    Returns ``(V (C, T, S, L), caps (C, L), comps (T,), weights (T,),
    steps (T, S) | None, evaluators)``.
    """
    from .netsim import compute_time
    from .planeval import JobSetEvaluator, LRUCache
    from .strategy_search import demand_cache_size

    if demand_cache is None:
        demand_cache = LRUCache(demand_cache_size())
    labels = [t.label for t in candidates[0].tenants]
    for js in candidates:
        if [t.label for t in js.tenants] != labels:
            raise ValueError(
                "grid candidates must list the same tenants in the same "
                "order"
            )
    evs = []
    vecs_per = []
    for js, topo in zip(candidates, topos):
        jse = JobSetEvaluator(
            js, topo, hw, overlap=overlap, demand_cache=demand_cache
        )
        # Price every entry before reading n_links: the link universe
        # grows as new MP routes compile.
        vecs = [
            [jse.tenant_loads_at(t.label, s, t.servers) for s in pools[i]]
            for i, t in enumerate(js.tenants)
        ]
        evs.append(jse)
        vecs_per.append(vecs)
    C, T, S = len(candidates), len(labels), len(pools[0])
    L = max(max(jse.ev.n_links for jse in evs), 1)
    if pad_to > 1:
        L = -(-L // pad_to) * pad_to
    V = np.zeros((C, T, S, L), dtype=np.float64)
    caps = np.full((C, L), float(pad_cap), dtype=np.float64)
    for ci, (jse, vecs) in enumerate(zip(evs, vecs_per)):
        nl = jse.ev.n_links
        if nl:
            caps[ci, :nl] = jse.ev.caps
        for i in range(T):
            for s, v in enumerate(vecs[i]):
                V[ci, i, s, : v.size] = v
    tenants = candidates[0].tenants
    comps = np.array(
        [compute_time(t.flops_per_iteration, t.k, hw) for t in tenants]
    )
    weights = np.array([t.weight for t in tenants], dtype=np.float64)
    steps = None
    if hw.link_latency:
        # Latency rounds are placement-independent (group sizes and pinned
        # steps survive remapping), so one candidate's table serves all.
        steps = np.asarray([
            [evs[0]._steps(t.label, s) for s in pools[i]]
            for i, t in enumerate(tenants)
        ], dtype=np.float64)
    return V, caps, comps, weights, steps, evs


def run_chains_reference(
    V: np.ndarray,
    caps: np.ndarray,
    comps: np.ndarray,
    weights: np.ndarray,
    overlap: float,
    objective: str,
    init_a: np.ndarray,
    temperatures: np.ndarray,
    t_idx: np.ndarray,
    s_idx: np.ndarray,
    u: np.ndarray,
    steps: np.ndarray | None = None,
    alpha: float = 0.0,
):
    """Sequential NumPy replay of the batched chains: same pre-drawn
    streams, same annealing rule, one chain at a time — the equivalence
    oracle the tests pin :meth:`TorchChainKernel.run` against."""
    K, iters = t_idx.shape
    T = V.shape[0]
    best_as = np.zeros((K, T), dtype=np.int64)
    bests = np.zeros(K, dtype=np.float64)
    hists = np.zeros((K, iters + 1), dtype=np.float64)
    for c in range(K):
        a = np.array(init_a, dtype=np.int64)
        cur = _objective_reference(
            V, caps, comps, weights, overlap, objective, a,
            steps=steps, alpha=alpha,
        )
        best_a, best = a.copy(), cur
        hists[c, 0] = cur
        for i in range(iters):
            cand_a = a.copy()
            cand_a[t_idx[c, i]] = s_idx[c, i]
            cand = _objective_reference(
                V, caps, comps, weights, overlap, objective, cand_a,
                steps=steps, alpha=alpha,
            )
            temp = temperatures[c] * max(cur, 1e-12)
            if cand <= cur or u[c, i] < math.exp(-(cand - cur) / temp):
                a, cur = cand_a, cand
                if cand < best:
                    best_a, best = cand_a.copy(), cand
            hists[c, i + 1] = cur
        best_as[c] = best_a
        bests[c] = best
    return best_as, bests, hists


def _swap_pass_reference(
    A: np.ndarray,  # (M, T) ladder states, mutated in place
    cur: np.ndarray,  # (M,) ladder energies, mutated in place
    temps: np.ndarray,  # (M,) ascending ladder
    su: np.ndarray,  # (M // 2,) swap uniforms of this iteration
    parity: int,
):
    """One even/odd neighbor swap pass — the host mirror of the grid
    kernel's tempering exchange (same clipping of the out-of-range last
    pair, same Metropolis swap acceptance)."""
    M = cur.shape[0]
    for p in range(M // 2):
        lo = 2 * p + parity
        hi = lo + 1
        if hi >= M:
            continue
        delta = (1.0 / temps[lo] - 1.0 / temps[hi]) * (cur[lo] - cur[hi])
        # exp saturates above ~709; any delta past ~50 already accepts
        # with certainty against a uniform < 1 (the device side computes
        # exp(delta) = inf, which accepts identically).
        if su[p] < math.exp(min(delta, 50.0)):
            A[[lo, hi]] = A[[hi, lo]]
            cur[lo], cur[hi] = cur[hi], cur[lo]
    return A, cur


def run_grid_reference(
    V: np.ndarray,  # (C, T, S, L)
    caps: np.ndarray,  # (C, L)
    comps: np.ndarray,
    weights: np.ndarray,
    overlap: float,
    objective: str,
    init_a: np.ndarray,  # (C, T)
    temperatures: np.ndarray,  # (M,)
    t_idx: np.ndarray,  # (C, K, M, iters)
    s_idx: np.ndarray,
    u: np.ndarray,
    swap_u: np.ndarray,  # (C, K, iters, M // 2)
    steps: np.ndarray | None = None,
    alpha: float = 0.0,
):
    """Sequential NumPy replay of the fused (candidate x chain x rung)
    grid: one cell at a time, same pre-drawn streams, same per-rung
    annealing rule, same even/odd swap passes — the equivalence oracle the
    tests pin :meth:`TorchChainKernel.run_grid` against."""
    C, K, M, iters = t_idx.shape
    T = V.shape[1]
    temps = np.asarray(temperatures, dtype=np.float64)
    best_as = np.zeros((C, K, T), dtype=np.int64)
    bests = np.zeros((C, K), dtype=np.float64)
    hists = np.zeros((C, K, iters + 1), dtype=np.float64)

    def obj(ci, a):
        return _objective_reference(
            V[ci], caps[ci], comps, weights, overlap, objective, a,
            steps=steps, alpha=alpha,
        )

    for ci in range(C):
        for c in range(K):
            A = np.tile(init_a[ci].astype(np.int64), (M, 1))
            cur = np.array([obj(ci, A[m]) for m in range(M)])
            m0 = int(np.argmin(cur))
            best_a, best = A[m0].copy(), cur[m0]
            hists[ci, c, 0] = cur[m0]
            for i in range(iters):
                for m in range(M):
                    cand_a = A[m].copy()
                    cand_a[t_idx[ci, c, m, i]] = s_idx[ci, c, m, i]
                    cand = obj(ci, cand_a)
                    temp = temps[m] * max(cur[m], 1e-12)
                    if cand <= cur[m] or u[ci, c, m, i] < math.exp(
                        -(cand - cur[m]) / temp
                    ):
                        A[m] = cand_a
                        cur[m] = cand
                if M > 1:
                    _swap_pass_reference(
                        A, cur, temps, swap_u[ci, c, i], i % 2
                    )
                m_star = int(np.argmin(cur))
                if cur[m_star] < best:
                    best_a, best = A[m_star].copy(), cur[m_star]
                hists[ci, c, i + 1] = cur[m_star]
            best_as[ci, c] = best_a
            bests[ci, c] = best
    return best_as, bests, hists
