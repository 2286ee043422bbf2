"""TotientPerms (paper Algorithm 2, §4.2) — ring-AllReduce permutations.

Theorem 2 (paper, App. E.1): for a cluster of ``n`` nodes, every integer
``p < n`` with ``gcd(p, n) == 1`` generates a unique *regular* ring
permutation ``S_i -> S_{(i+p) mod n}``.  These are exactly the generators of
the cyclic group Z_n^+, and their count is Euler's totient ``phi(n)`` —
hence the algorithm's name.  At large ``n`` the paper prunes the stride set
to the primes (plus 1), shrinking it to ``O(n / ln n)`` by the Prime Number
Theorem (:func:`prime_coprimes`).

Notation mapping (paper -> code): servers ``S_i`` -> group-local indices
``0..k-1``; a permutation ``p`` -> :class:`RingPermutation` (``.p`` is the
stride, ``.members`` maps local index -> cluster node id); the output set
``P`` of Algorithm 2 -> :class:`PermutationSet`.  The AllReduce group may be
a subset of the cluster (hybrid strategies replicate a layer over ``k`` of
``n`` servers); permutations are generated in the *group-local* index space
and mapped back onto the member node ids, so a stride's physical edges come
from :meth:`RingPermutation.edges`.

Downstream: :func:`repro_torch.core.select_perms.select_permutations` (Alg. 3)
picks ``d_k`` of these strides per group; CoinChangeMod (Alg. 4) then routes
arbitrary pairs over the chosen rings.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence


def coprimes(n: int) -> list[int]:
    """All valid ring strides for a group of size ``n`` (Euler totient set)."""
    if n < 2:
        return []
    return [p for p in range(1, n) if math.gcd(p, n) == 1]


def prime_coprimes(n: int) -> list[int]:
    """Strides restricted to primes (plus 1) — the paper's large-scale
    reduction of the search space to O(n / ln n) via the Prime Number
    Theorem."""

    def is_prime(x: int) -> bool:
        if x < 2:
            return False
        for f in range(2, int(math.isqrt(x)) + 1):
            if x % f == 0:
                return False
        return True

    return [1] + [p for p in coprimes(n) if is_prime(p)]


def ring_order(n: int, p: int, start: int = 0) -> list[int]:
    """Visit order of the stride-``p`` ring over group-local ids 0..n-1."""
    if math.gcd(p, n) != 1:
        raise ValueError(f"stride p={p} is not coprime with n={n}: not a ring")
    return [(start + i * p) % n for i in range(n)]


def ring_edges(n: int, p: int) -> list[tuple[int, int]]:
    """Directed edges of the stride-``p`` ring: i -> (i+p) mod n."""
    order = ring_order(n, p)
    return [(order[i], order[(i + 1) % n]) for i in range(n)]


def is_valid_ring(n: int, edges: Sequence[tuple[int, int]]) -> bool:
    """A ring visits every node exactly once (Hamiltonian directed cycle)."""
    if len(edges) != n:
        return False
    nxt = {}
    for a, b in edges:
        if a in nxt:
            return False
        nxt[a] = b
    cur, seen = 0, set()
    for _ in range(n):
        if cur in seen or cur not in nxt:
            return False
        seen.add(cur)
        cur = nxt[cur]
    return cur == 0 and len(seen) == n


@dataclass(frozen=True)
class RingPermutation:
    """One stride-``p`` regular ring over an AllReduce group.

    ``members`` maps group-local index -> cluster node id.  ``edges()``
    returns cluster-level directed edges.
    """

    p: int
    members: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.members)

    def order(self) -> list[int]:
        return [self.members[i] for i in ring_order(self.size, self.p)]

    def edges(self) -> list[tuple[int, int]]:
        return [(self.members[a], self.members[b]) for a, b in ring_edges(self.size, self.p)]


@dataclass
class PermutationSet:
    """Output of TotientPerms for one AllReduce group."""

    group: tuple[int, ...]
    perms: list[RingPermutation] = field(default_factory=list)

    @property
    def strides(self) -> list[int]:
        return [r.p for r in self.perms]


def totient_perms(members: Sequence[int], prime_only: bool | None = None) -> PermutationSet:
    """Algorithm 2.  Generate all regular ring permutations for an AllReduce
    group.

    Args:
      members: cluster node ids participating in this AllReduce group.
      prime_only: restrict strides to primes.  Defaults to automatic —
        full totient set for small groups, primes for k > 64 (the paper's
        large-scale mode).
    """
    members = tuple(members)
    k = len(members)
    if k < 2:
        return PermutationSet(group=members, perms=[])
    if prime_only is None:
        prime_only = k > 64
    strides = prime_coprimes(k) if prime_only else coprimes(k)
    perms = [RingPermutation(p=p, members=members) for p in strides]
    return PermutationSet(group=members, perms=perms)


def totient_perms_grouped(n: int, k: int, prime_only: bool | None = None) -> list[PermutationSet]:
    """Paper's Algorithm 2 signature: ``n`` total nodes partitioned into
    contiguous AllReduce groups of size ``k`` (n/k groups), each getting the
    same stride set.  Used when a layer is replicated across k-subsets."""
    if n % k != 0:
        raise ValueError(f"group size k={k} must divide n={n}")
    return [
        totient_perms(range(g * k, (g + 1) * k), prime_only=prime_only)
        for g in range(n // k)
    ]
