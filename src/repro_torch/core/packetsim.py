"""Deprecated shim — the event-driven flow simulator lives in
:mod:`repro_torch.core.simengine` now.

``FlowSim`` remains importable with its original interface, but it is a
thin wrapper over :class:`repro_torch.core.simengine.FlowSimVec`, the vectorized
rewrite (flows x links incidence arrays instead of per-flow dicts).  Every
name imported from *this* module emits a :class:`DeprecationWarning`; new
code should use :class:`repro_torch.core.simengine.SimEngine` directly, which
also expresses the shared-cluster / failure / reconfiguration scenarios
this module never could.
"""

from __future__ import annotations

import warnings

from . import simengine as _simengine

_FlowSim = None


def _flow_sim_class():
    """Build the legacy ``FlowSim`` subclass lazily so plain module import
    stays warning-free."""
    global _FlowSim
    if _FlowSim is None:

        class FlowSim(_simengine.FlowSimVec):
            """Deprecated alias of :class:`repro_torch.core.simengine.FlowSimVec`."""

        _FlowSim = FlowSim
    return _FlowSim


def _links_of(topology_graph) -> dict[tuple[int, int], float]:
    """Aggregate parallel links of a MultiDiGraph into per-pair capacity
    multipliers (callers scale by per-link bandwidth)."""
    caps: dict[tuple[int, int], float] = {}
    for a, b in topology_graph.edges():
        caps[(a, b)] = caps.get((a, b), 0.0) + 1.0
    return caps


_DEPRECATED_SHIMS = {
    "PROPAGATION_DELAY": lambda: _simengine.PROPAGATION_DELAY,
    "FlowSimVec": lambda: _simengine.FlowSimVec,
    "SimResult": lambda: _simengine.SimResult,
    "Task": lambda: _simengine.Task,
    "FlowSim": _flow_sim_class,
    "links_of": lambda: _links_of,
}


def __getattr__(name: str):
    shim = _DEPRECATED_SHIMS.get(name)
    if shim is not None:
        warnings.warn(
            f"repro_torch.core.packetsim.{name} is deprecated; use "
            "repro_torch.core.simengine (FlowSimVec / SimEngine) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        return shim()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
