"""SelectPermutations (paper Algorithm 3, §4.2) — pick ``d_k`` ring strides.

Goal (Theorem 1): choose strides close to a geometric sequence with ratio
``x = n^(1/d_k)`` so that the AllReduce sub-topology's diameter is bounded by
``O(d_k * n^(1/d_k))`` — every node reaches every other within a small number
of coin-change hops (App. E.2), Chord-style.

Notation mapping (paper -> code): the candidate set ``P`` from TotientPerms
-> :class:`repro_torch.core.totient.PermutationSet`; the per-group degree budget
``d_k`` -> the ``d_k`` argument; the geometric targets ``x^0..x^(d_k-1)`` ->
:func:`geometric_targets` (with the paper's App. E.2 correction to ratio 2
when ``n^(1/d_k) < 2``); the greedy L1-nearest projection of targets onto
available strides (without replacement) -> :func:`select_permutations`;
Theorem 1's diameter quantity -> :func:`coin_change_diameter` (exact BFS
over Z_n treating the chosen strides as +coins) and its analytic bound ->
:func:`theorem1_bound`.
"""

from __future__ import annotations

from .totient import PermutationSet, RingPermutation


def geometric_targets(n: int, d: int) -> list[float]:
    """The ideal stride sequence x^0, x^1, ..., x^(d-1) with x = n^(1/d).

    When n^(1/d) < 2 the paper switches to ratio 2 (uses fewer effective
    degrees, bound becomes O(log2 n))."""
    if d <= 0:
        return []
    x = n ** (1.0 / d)
    if x < 2.0 and n > 1:
        x = 2.0
    return [x**i for i in range(d)]


def select_permutations(perm_set: PermutationSet, d_k: int) -> list[RingPermutation]:
    """Algorithm 3.  Greedily project the geometric sequence onto the
    available totient strides (L1-nearest, without replacement)."""
    if d_k <= 0 or not perm_set.perms:
        return []
    by_stride = {r.p: r for r in perm_set.perms}
    candidates = sorted(by_stride)
    n = perm_set.perms[0].size
    d_k = min(d_k, len(candidates))

    selected: list[int] = []
    # q starts at the minimum candidate (stride 1 when present).
    q = candidates[0]
    selected.append(q)
    remaining = [c for c in candidates if c != q]
    x = geometric_targets(n, d_k)
    ratio = x[1] / x[0] if len(x) > 1 else 2.0

    for _ in range(1, d_k):
        if not remaining:
            break
        target = q * ratio
        # L1-nearest projection onto remaining candidates.
        qp = min(remaining, key=lambda r: abs(r - target))
        selected.append(qp)
        remaining.remove(qp)
        q = qp

    return [by_stride[p] for p in selected]


def schedule_strides(
    n: int, family: str, d: int | None = None
) -> tuple[int, ...]:
    """Stride set for one collective-schedule family on a group of ``n``
    (the TotientPerms extension backing :mod:`repro_torch.core.schedules`).

    * ``"ring"`` / ``"multi_tree"`` — Algorithm 3's geometric selection over
      the coprime strides (``d`` rings, or ``d`` tree-seeding ring orders).
    * ``"recursive_hd"`` — the power-of-two exchange distances
      ``1, 2, 4, ... < p2`` where ``p2`` is the largest power of two
      ``<= n`` (the halving-doubling pairing offsets, not modular rings).

    ``d=None`` keeps the family's natural length.
    """
    if n < 2:
        return ()
    if family in ("ring", "multi_tree"):
        from .totient import totient_perms

        perms = totient_perms(tuple(range(n)))
        want = len(perms.perms) if d is None else d
        return tuple(r.p for r in select_permutations(perms, want))
    if family == "recursive_hd":
        out: list[int] = []
        s = 1
        while s * 2 <= n:
            out.append(s)
            s *= 2
        return tuple(out if d is None else out[:d])
    raise ValueError(
        f"unknown schedule family {family!r}: "
        "expected 'ring', 'recursive_hd' or 'multi_tree'"
    )


def coin_change_diameter(n: int, strides: list[int]) -> int:
    """Exact diameter of the union of the stride rings under directed
    coin-change routing (BFS over Z_n with the strides as +coins).

    Used by tests to check Theorem 1 and by TopologyFinder to report the
    cluster diameter seen by MP transfers."""
    if n <= 1:
        return 0
    if not strides:
        return -1  # disconnected
    dist = [-1] * n
    dist[0] = 0
    frontier = [0]
    while frontier:
        nxt = []
        for v in frontier:
            for c in strides:
                w = (v + c) % n
                if dist[w] < 0:
                    dist[w] = dist[v] + 1
                    nxt.append(w)
        frontier = nxt
    if any(d < 0 for d in dist):
        return -1
    return max(dist)


def theorem1_bound(n: int, d: int) -> float:
    """O(d * n^(1/d)) bound, with the x<2 correction of App. E.2."""
    if d <= 0:
        return float("inf")
    x = n ** (1.0 / d)
    if x < 2.0:
        import math

        return math.log2(max(n, 2)) + 1
    return d * x
