"""Seeded fault injection: transient fiber flaps, correlated failure
domains, and the disruption streams they induce (§7 failure handling).

A :class:`FaultModel` turns per-component MTBF/MTTR parameters into two
equivalent fault streams:

* :meth:`FaultModel.link_failures` — engine-granularity
  :class:`~repro_torch.core.simengine.LinkFailure` events (absolute seconds,
  ``repair_time`` set) for :class:`~repro_torch.core.simengine.Scenario` runs;
* :meth:`FaultModel.events` — iteration-granularity
  :class:`~repro_torch.core.online.TraceEvent` fail/repair pairs for the online
  drivers (:func:`~repro_torch.core.online.run_online` /
  :func:`~repro_torch.core.online.run_online_jobset`).

Components fail as independent renewal processes (exponential inter-failure
times with mean ``mtbf``, exponential outage durations with mean ``mttr``):

* every fiber pair in :attr:`FaultModel.links` flaps on its own
  (``link_mtbf`` / ``link_mttr``);
* every :class:`FaultDomain` takes out its *whole* link set atomically —
  :func:`server_domain` (a server or its NIC dies: all incident fibers go
  down together) and :func:`stride_domain` (an OCS plane / patch-panel
  tray dies: the entire stride group of the ring fabric goes with it)
  build the two correlated shapes the paper's fault analysis needs.

Determinism: component ``i`` draws from ``np.random.default_rng((seed, i))``
— its own counter-based substream — so adding or removing a domain never
shifts any other component's timeline, and the same seed reproduces the
same storm bit for bit.  Overlapping outages of the same pair (its own flap
plus a domain cut) are union-merged per pair before emission, so every
``fail`` has exactly one matching ``repair`` and the engine's capacity
snapshots can never double-cut.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from .online import TraceEvent
from .simengine import LinkFailure

__all__ = [
    "FaultDomain",
    "FaultModel",
    "server_domain",
    "stride_domain",
]

# An exponential outage duration is almost surely positive, but LinkFailure
# demands repair strictly after failure — floor the duration defensively.
_MIN_OUTAGE_S = 1e-12


def _norm(pair: Iterable[int]) -> tuple[int, int]:
    a, b = pair
    return (min(int(a), int(b)), max(int(a), int(b)))


@dataclass(frozen=True)
class FaultDomain:
    """A correlated failure domain: every pair in ``links`` dies *and*
    repairs atomically (one shared outage clock).

    ``mtbf`` is the mean seconds between the domain's failures, ``mttr``
    the mean outage duration — e.g. a server power-cycle takes all of its
    fibers down for the reboot, an OCS plane swap takes a whole stride
    group down for the maintenance window."""

    name: str
    links: tuple[tuple[int, int], ...]
    mtbf: float
    mttr: float

    def __post_init__(self):
        object.__setattr__(
            self, "links", tuple(sorted({_norm(p) for p in self.links}))
        )
        if self.mtbf <= 0 or self.mttr <= 0:
            raise ValueError(
                f"domain {self.name!r} needs positive mtbf/mttr, got "
                f"{self.mtbf}/{self.mttr}"
            )


def server_domain(
    server: int,
    links: Iterable[tuple[int, int]],
    mtbf: float,
    mttr: float,
    name: str | None = None,
) -> FaultDomain:
    """The correlated domain of a server (or its NIC) dying: every fiber
    pair incident to ``server`` in ``links`` fails atomically."""
    pairs = sorted({_norm(p) for p in links if server in (p[0], p[1])})
    if not pairs:
        raise ValueError(f"server {server} has no incident links")
    return FaultDomain(
        name=name or f"server{server}", links=tuple(pairs),
        mtbf=mtbf, mttr=mttr,
    )


def stride_domain(
    n: int,
    stride: int,
    mtbf: float,
    mttr: float,
    name: str | None = None,
) -> FaultDomain:
    """The correlated domain of an OCS plane / patch-panel tray dying: the
    whole stride group ``{(i, (i + stride) mod n)}`` — one ring fabric's
    worth of fibers, the unit an optical plane carries — fails atomically."""
    if not 0 < stride < n:
        raise ValueError(f"stride {stride} must be in (0, {n})")
    pairs = sorted({_norm((i, (i + stride) % n)) for i in range(n)})
    return FaultDomain(
        name=name or f"stride{stride}", links=tuple(pairs),
        mtbf=mtbf, mttr=mttr,
    )


@dataclass
class FaultModel:
    """Seeded generator of transient-fault storms over a fabric.

    ``links`` is the fiber population subject to independent flapping
    (``link_mtbf`` / ``link_mttr``; ``link_mtbf=None`` disables flaps so a
    model can carry only correlated domains).  ``domains`` adds correlated
    failure domains on top.  All times are seconds."""

    n: int
    links: tuple[tuple[int, int], ...] = ()
    link_mtbf: float | None = None
    link_mttr: float = 1.0
    domains: list[FaultDomain] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self.links = tuple(sorted({_norm(p) for p in self.links}))
        if self.link_mtbf is not None and self.link_mtbf <= 0:
            raise ValueError(f"link_mtbf must be positive, got {self.link_mtbf}")
        if self.link_mttr <= 0:
            raise ValueError(f"link_mttr must be positive, got {self.link_mttr}")

    @classmethod
    def for_topology(
        cls,
        topo,
        link_mtbf: float | None = None,
        link_mttr: float = 1.0,
        domains: list[FaultDomain] | None = None,
        seed: int = 0,
    ) -> "FaultModel":
        """A model whose fiber population is ``topo``'s live pairs."""
        pairs = sorted({_norm((a, b)) for a, b in topo.graph.edges()})
        return cls(
            n=topo.n, links=tuple(pairs), link_mtbf=link_mtbf,
            link_mttr=link_mttr, domains=list(domains or []), seed=seed,
        )

    # -- renewal-process generation ------------------------------------------

    def _components(self) -> list[tuple[tuple[tuple[int, int], ...], float, float]]:
        """(pairs, mtbf, mttr) per independent failure clock.  Flapping
        fibers come first in a fixed sorted order, then the domains in
        declaration order — so component ``i``'s substream is stable under
        adding/removing *later* components."""
        comps: list[tuple[tuple[tuple[int, int], ...], float, float]] = []
        if self.link_mtbf is not None:
            for pair in self.links:
                comps.append(((pair,), self.link_mtbf, self.link_mttr))
        for d in self.domains:
            comps.append((d.links, d.mtbf, d.mttr))
        return comps

    def outages(self, horizon: float) -> dict[tuple[int, int], list[tuple[float, float]]]:
        """Per-pair union-merged outage intervals ``[(t_fail, t_repair),
        ...]`` over ``[0, horizon)`` seconds, each list sorted and
        non-overlapping.  Repairs may land past the horizon (an outage in
        progress when the storm window closes still heals eventually)."""
        raw: dict[tuple[int, int], list[tuple[float, float]]] = {}
        for idx, (pairs, mtbf, mttr) in enumerate(self._components()):
            rng = np.random.default_rng((self.seed, idx))
            t = 0.0
            while True:
                t += float(rng.exponential(mtbf))
                if t >= horizon:
                    break
                t_rep = t + max(float(rng.exponential(mttr)), _MIN_OUTAGE_S)
                for pair in pairs:
                    raw.setdefault(pair, []).append((t, t_rep))
                # The component cannot fail again while it is down.
                t = t_rep
        merged: dict[tuple[int, int], list[tuple[float, float]]] = {}
        for pair, ivals in raw.items():
            ivals.sort()
            out: list[list[float]] = []
            for t0, t1 in ivals:
                if out and t0 <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], t1)
                else:
                    out.append([t0, t1])
            merged[pair] = [(t0, t1) for t0, t1 in out]
        return merged

    def link_failures(self, horizon: float) -> list[LinkFailure]:
        """The storm as engine events: one transient
        :class:`~repro_torch.core.simengine.LinkFailure` (``repair_time`` set)
        per merged outage interval, sorted by failure time."""
        failures = [
            LinkFailure(time=t0, link=pair, repair_time=t1)
            for pair, ivals in self.outages(horizon).items()
            for t0, t1 in ivals
        ]
        failures.sort(key=lambda f: (f.time, f.link))
        return failures

    def events(self, n_iters: int, iter_time: float) -> tuple[TraceEvent, ...]:
        """The storm as an online trace: iteration-granularity ``fail`` /
        ``repair`` :class:`~repro_torch.core.online.TraceEvent` pairs over
        ``n_iters`` iterations of estimated length ``iter_time`` seconds.

        Events keep chronological order (quantization never reorders a
        pair's fail/repair alternation); repairs quantized past the last
        iteration are clamped onto it so every storm the driver sees heals
        within the run."""
        if iter_time <= 0:
            raise ValueError(f"iter_time must be positive, got {iter_time}")
        horizon = n_iters * iter_time
        timed: list[tuple[float, int, TraceEvent]] = []
        for pair, ivals in self.outages(horizon).items():
            for t0, t1 in ivals:
                it_fail = min(int(t0 / iter_time), n_iters - 1)
                it_rep = min(max(int(t1 / iter_time), it_fail), n_iters - 1)
                timed.append(
                    (t0, 0, TraceEvent(iteration=it_fail, kind="fail",
                                       link=pair)))
                timed.append(
                    (t1, 1, TraceEvent(iteration=it_rep, kind="repair",
                                       link=pair)))
        timed.sort(key=lambda rec: (rec[0], rec[1], rec[2].link))
        return tuple(ev for _, _, ev in timed)
