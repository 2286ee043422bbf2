"""OCS-reconfig heuristic (Algorithm 5, App. E.4).

Periodically (every 50 ms) rebuilds the direct-connect topology from the
*unsatisfied* traffic demand: repeatedly give a link to the highest-demand
pair, discounting served demand by 1/2 per parallel link (Eq. 2's
exponential Discount), then 2-edge-replacement to restore connectivity.
A 10 ms reconfiguration pause is charged on every rebuild (§5.1).

The epoch scheduling itself lives in :class:`repro_torch.core.simengine.SimEngine`
(``OCSPolicy`` scenarios and ``reconfig_drain``); this module only builds
one topology from one demand snapshot.  Importing ``ocs_topology`` /
``RECONFIG_WINDOW`` / ``RECONFIG_LATENCY`` from *this* module emits a
:class:`DeprecationWarning`; the same names are warning-free on
``repro_torch.core.simengine``.
"""

from __future__ import annotations

import warnings

import networkx as nx
import numpy as np

_RECONFIG_WINDOW = 50e-3
_RECONFIG_LATENCY = 10e-3


def _ocs_topology(
    n: int, demand: np.ndarray, degree: int, ensure_connected: bool = True
) -> nx.MultiDiGraph:
    """Algorithm 5: greedy max-demand link allocation with halving."""
    t = demand.astype(np.float64).copy()
    np.fill_diagonal(t, 0.0)
    avail_tx = np.full(n, degree)
    avail_rx = np.full(n, degree)
    g = nx.MultiDiGraph()
    g.add_nodes_from(range(n))

    while True:
        masked = t.copy()
        masked[avail_tx <= 0, :] = -1.0
        masked[:, avail_rx <= 0] = -1.0
        np.fill_diagonal(masked, -1.0)
        i, j = np.unravel_index(np.argmax(masked), masked.shape)
        if masked[i, j] <= 0:
            break
        g.add_edge(int(i), int(j), kind="ocs")
        t[i, j] /= 2.0  # Discount(l) = sum 2^-x
        avail_tx[i] -= 1
        avail_rx[j] -= 1

    if ensure_connected:
        _two_edge_replacement(g, n, avail_tx, avail_rx)
    return g


def _two_edge_replacement(
    g: nx.MultiDiGraph, n: int, avail_tx: np.ndarray, avail_rx: np.ndarray
) -> None:
    """OWAN-style repair: connect weak components, first with spare
    interfaces, then by stealing a parallel link."""
    for _ in range(2 * n):
        comps = list(nx.weakly_connected_components(nx.DiGraph(g)))
        if len(comps) <= 1:
            return
        a_set, b_set = comps[0], comps[1]
        src = next((v for v in a_set if avail_tx[v] > 0), None)
        dst = next((v for v in b_set if avail_rx[v] > 0), None)
        if src is not None and dst is not None:
            g.add_edge(src, dst, kind="repair")
            avail_tx[src] -= 1
            avail_rx[dst] -= 1
            # also the reverse to keep strong reachability cheap
            if avail_tx[dst] > 0 and avail_rx[src] > 0:
                g.add_edge(dst, src, kind="repair")
                avail_tx[dst] -= 1
                avail_rx[src] -= 1
            continue
        # True 2-edge replacement (OWAN): remove one intra-A and one intra-B
        # edge, rewire them across the cut.  Degrees are preserved.
        edge_a = next(
            ((u, v) for u, v in g.edges() if u in a_set and v in a_set), None
        )
        edge_b = next(
            ((x, y) for x, y in g.edges() if x in b_set and y in b_set), None
        )
        if edge_a is None or edge_b is None:
            return
        (u, v), (x, y) = edge_a, edge_b
        g.remove_edge(u, v, key=next(iter(g[u][v])))
        g.remove_edge(x, y, key=next(iter(g[x][y])))
        g.add_edge(u, y, kind="repair")
        g.add_edge(x, v, kind="repair")


# -- deprecated shim surface -------------------------------------------------

_DEPRECATED_SHIMS = {
    "ocs_topology": lambda: _ocs_topology,
    "RECONFIG_WINDOW": lambda: _RECONFIG_WINDOW,
    "RECONFIG_LATENCY": lambda: _RECONFIG_LATENCY,
}


def __getattr__(name: str):
    shim = _DEPRECATED_SHIMS.get(name)
    if shim is not None:
        warnings.warn(
            f"repro_torch.core.ocs_reconfig.{name} is deprecated; import it from "
            "repro_torch.core.simengine (or drive OCS epochs via "
            "SimEngine + OCSPolicy) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        return shim()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
