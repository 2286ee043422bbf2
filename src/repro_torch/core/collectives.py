"""TotientPerms collectives over ``torch.distributed`` (§6 "Modifications to
NCCL"; ``repro.core.collectives``'s counterpart).

The paper integrates TotientPerms into NCCL so parameter synchronization is
load-balanced across several ring-AllReduce permutations.  The JAX package
writes each schedule with ``lax.ppermute`` inside ``shard_map``; here each
``ppermute`` round is one ``dist.batch_isend_irecv`` in which every rank
posts its send and its receive together, so no rank waits on another's
order.  A rank that receives nothing in a round gets zeros, as from
``ppermute``.

Each function takes the mesh axis where JAX takes ``axis_name``: a
:class:`~repro_torch.core.device_order.MeshAxis` (``mesh.axis(name)``).  A
rank's position is its mesh coordinate (``lax.axis_index``), not its rank
in a process group, and peers are addressed by the global rank at a mesh
position.  The segments, their padding and the order of every addition are
JAX's, so float32 results equal the JAX package's to the bit.  CUDA tensors
go over NCCL and CPU tensors over gloo; a tensor on the other backend's
device raises.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.distributed as dist

from .device_order import MeshAxis
from .totient import ring_order


def _mod_inverse(p: int, n: int) -> int:
    if math.gcd(p, n) != 1:
        raise ValueError(f"stride {p} not coprime with ring size {n}")
    return pow(p, -1, n)


def _ring_perm(n: int, p: int) -> list[tuple[int, int]]:
    """ppermute pairs: position i sends to (i + p) mod n."""
    return [(i, (i + p) % n) for i in range(n)]


def _check_backend(x: torch.Tensor) -> None:
    want = "nccl" if x.is_cuda else "gloo"
    got = dist.get_backend()
    if got != want:
        raise RuntimeError(f"a {x.device.type} tensor goes over {want}, and the process "
                           f"group is {got}")


def ppermute(x: torch.Tensor, axis: MeshAxis, perm) -> torch.Tensor:
    """``lax.ppermute``: position ``src`` sends ``x`` to position ``dst`` for
    every ``(src, dst)`` in ``perm``; returns what this rank received, zeros
    where it receives nothing."""
    _check_backend(x)
    me, ranks = axis.index, axis.ranks
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[dst]))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src]))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _pad_flat(x: torch.Tensor, parts: int) -> tuple[torch.Tensor, int]:
    """x flattened and zero-padded to ``parts`` equal rows -> ((parts, seg), pad)."""
    flat = x.reshape(-1)
    seg = -(-flat.numel() // parts)  # ceil
    pad = seg * parts - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(parts, seg).clone(), pad


def _unpad(acc: torch.Tensor, pad: int, shape) -> torch.Tensor:
    out = acc.reshape(-1)
    if pad:
        out = out[: out.numel() - pad]
    return out.reshape(shape)


def ring_all_reduce(x: torch.Tensor, axis: MeshAxis, p: int = 1) -> torch.Tensor:
    """Ring AllReduce over the stride-``p`` permutation of ``axis``: a
    reduce-scatter and an all-gather of n-1 rounds each."""
    n = axis.size
    if n == 1:
        return x
    inv_p = _mod_inverse(p, n)
    perm = _ring_perm(n, p)
    # Position of this rank along the ring: the ring visits (j * p) % n.
    pos = (axis.index * inv_p) % n
    acc, pad = _pad_flat(x, n)

    # Reduce-scatter: after n-1 rounds, ring position j owns segment (j + 1) % n.
    for t in range(n - 1):
        send_idx, recv_idx = (pos - t) % n, (pos - t - 1) % n
        received = ppermute(acc[send_idx], axis, perm)
        acc[recv_idx] = acc[recv_idx] + received
    # All-gather the reduced segments back around the same ring.
    for t in range(n - 1):
        send_idx, recv_idx = (pos + 1 - t) % n, (pos - t) % n
        acc[recv_idx] = ppermute(acc[send_idx], axis, perm)
    return _unpad(acc, pad, x.shape)


def ring_reduce_scatter(x: torch.Tensor, axis: MeshAxis, p: int = 1) -> torch.Tensor:
    """Reduce-scatter over the stride-``p`` ring: returns this rank's reduced
    segment of the flattened, padded ``x``; ring position j owns segment
    (j + 1) % n."""
    n = axis.size
    if n == 1:
        return x.reshape(-1)
    inv_p = _mod_inverse(p, n)
    perm = _ring_perm(n, p)
    pos = (axis.index * inv_p) % n
    acc, _ = _pad_flat(x, n)
    for t in range(n - 1):
        send_idx, recv_idx = (pos - t) % n, (pos - t - 1) % n
        received = ppermute(acc[send_idx], axis, perm)
        acc[recv_idx] = acc[recv_idx] + received
    return acc[(pos + 1) % n]


def _split_reduce(x: torch.Tensor, r: int, reduce_chunk) -> torch.Tensor:
    """x split into ``r`` equal chunks of its padded flat form, chunk i reduced
    by ``reduce_chunk(chunk, i)``, then joined back into x's shape."""
    chunks, pad = _pad_flat(x, r)
    reduced = torch.cat([reduce_chunk(chunks[i], i) for i in range(r)])
    return _unpad(reduced, pad, x.shape)


def multi_ring_all_reduce(x: torch.Tensor, axis: MeshAxis, strides) -> torch.Tensor:
    """AllReduce load-balanced over several TotientPerms rings (§6): ``x``
    splits into ``len(strides)`` equal chunks, and chunk r is reduced around
    the stride ``strides[r]`` ring."""
    strides = tuple(strides)
    r = len(strides)
    if r == 0:
        raise ValueError("need at least one ring stride")
    if r == 1:
        return ring_all_reduce(x, axis, strides[0])
    return _split_reduce(x, r, lambda c, i: ring_all_reduce(c, axis, strides[i]))


def recursive_hd_all_reduce(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Recursive halving-doubling AllReduce: ``log2(n)`` halving exchanges
    with partner ``i XOR d`` (a reduce-scatter), then ``log2(n)`` doubling
    exchanges (an all-gather).  Power-of-two groups only."""
    n = axis.size
    if n == 1:
        return x
    if n < 2 or n & (n - 1):
        raise ValueError(f"recursive halving-doubling needs a power-of-two group, got {n}")
    me = axis.index
    acc, pad = _pad_flat(x, n)

    # Halving: the live block [lo, lo + 2d) splits at each round; the kept
    # half accumulates the partner's complementary half.
    lo, d = 0, n // 2
    while d >= 1:
        bit = (me >> (d.bit_length() - 1)) & 1
        keep_lo = lo + bit * d
        send_lo = lo + (1 - bit) * d
        perm = [(i, i ^ d) for i in range(n)]
        received = ppermute(acc[send_lo:send_lo + d], axis, perm)
        acc[keep_lo:keep_lo + d] = acc[keep_lo:keep_lo + d] + received
        lo = keep_lo
        d //= 2
    # Rank i now owns the reduced segment i; doubling sends ever larger
    # aligned blocks back.
    d = 1
    while d < n:
        perm = [(i, i ^ d) for i in range(n)]
        received = ppermute(acc[lo:lo + d], axis, perm)
        acc[(lo ^ d):(lo ^ d) + d] = received
        lo = min(lo, lo ^ d)
        d *= 2
    return _unpad(acc, pad, x.shape)


def _tree_all_reduce(x: torch.Tensor, axis: MeshAxis, order: list[int]) -> torch.Tensor:
    """AllReduce over one balanced binary tree: heap node ``i`` (position
    ``order[i]``) parents ``order[(i-1)//2]``.  The reduce runs deepest
    level first (left and right children in separate rounds: a parent has
    one source a round), then the root's total is broadcast back down."""
    n = len(order)
    me = axis.index
    levels: list[list[int]] = []  # heap indices by depth: [1, 2], [3..6], ...
    start, width = 1, 2
    while start < n:
        levels.append(list(range(start, min(start + width, n))))
        start += width
        width *= 2
    acc = x
    for level in reversed(levels):
        for parity in (1, 0):  # left children first, then right
            pairs = [(order[i], order[(i - 1) // 2]) for i in level if i % 2 == parity]
            if pairs:
                # Non-recipients get zeros, so a plain add only changes the parents.
                acc = acc + ppermute(acc, axis, pairs)
    for level in levels:
        for parity in (1, 0):
            pairs = [(order[(i - 1) // 2], order[i]) for i in level if i % 2 == parity]
            if pairs:
                received = ppermute(acc, axis, pairs)
                if any(dst == me for _, dst in pairs):
                    acc = received
    return acc


def multi_tree_all_reduce(x: torch.Tensor, axis: MeshAxis, strides) -> torch.Tensor:
    """AllReduce load-balanced over several balanced binary trees, one per
    TotientPerms ring order: ``x`` splits into ``len(strides)`` chunks, and
    chunk r reduces up and broadcasts down the tree laid over the stride
    ``strides[r]`` ring order."""
    strides = tuple(strides)
    r = len(strides)
    if r == 0:
        raise ValueError("need at least one tree stride")
    n = axis.size
    if n == 1:
        return x
    orders = [[int(v) for v in ring_order(n, p)] for p in strides]
    return _split_reduce(x, r, lambda c, i: _tree_all_reduce(c, axis, orders[i]))


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``lax.psum``: one library all-reduce over the axis's process group
    (NCCL on the card, gloo on the CPU)."""
    if axis.size == 1:
        return x
    _check_backend(x)
    out = x.clone()
    dist.all_reduce(out, group=axis.group)
    return out


def topoopt_psum_fn(strides, axis: MeshAxis, schedule: str = "ring", group_size: int | None = None):
    """The gradient-sync collective a training step should use, selected from
    the searched ``Strategy.schedule``:

    * ``"ring"``: the multi-ring TotientPerms AllReduce when a plan supplies
      strides, else :func:`psum`.
    * ``"recursive_hd"``: recursive halving-doubling; when ``group_size`` is
      known and not a power of two, the ring family instead (the fold the
      demand compiler applies to straggler nodes).
    * ``"multi_tree"``: balanced binary trees seeded from the TotientPerms
      ring orders; without strides, :func:`psum`.
    """
    if schedule == "recursive_hd":
        if group_size is None or (group_size & (group_size - 1)) == 0:
            return partial(recursive_hd_all_reduce, axis=axis)
        schedule = "ring"  # straggler fold: non-power-of-two groups keep ringing
    elif schedule == "multi_tree":
        if strides:
            return partial(multi_tree_all_reduce, axis=axis, strides=tuple(strides))
        return partial(psum, axis=axis)
    elif schedule != "ring":
        raise ValueError(
            f"unknown collective schedule {schedule!r}: "
            "expected 'ring', 'recursive_hd' or 'multi_tree'"
        )
    if strides:
        return partial(multi_ring_all_reduce, axis=axis, strides=tuple(strides))
    return partial(psum, axis=axis)


def all_to_all_ring(x: torch.Tensor, axis: MeshAxis, p: int = 1) -> torch.Tensor:
    """All-to-all as n-1 rotations of the whole payload around a stride-``p``
    ring, keeping at each step the slice destined to this rank.  ``x``:
    (n, ...) per-destination data -> (n, ...) per-source data."""
    n = axis.size
    if n == 1:
        return x
    me = axis.index
    out = torch.zeros_like(x)
    out[me] = x[me]
    perm = _ring_perm(n, p)
    payload, src = x, me
    for _ in range(n - 1):
        payload = ppermute(payload, axis, perm)
        src = (src - p) % n
        out[src] = payload[me]
    return out
