"""The head-dim-80 attention backward's order of work, against the JAX package, on the CPU.

``csrc/flash_attention_bwd.cu`` computes S and dP once at D = 80: an item of
BM keys of one kv head walks the 64-row query tiles it sees (rotated so that
the items of a kv head reach each tile at different steps), rounds P and dS
to the input's 16-bit type, sums dK and dV over its walk in fp32, and adds
each tile's fp32 partial of dQ (dS K over its BM keys) into a buffer, the
items that see the tile taking turns in a fixed order; dQ is scaled and cast
once at the end.  The plain torch model here walks the tiles the same way,
with BM, BN and the walk and turn rules ported from the source (BM and BN
read from it), and is held to ``jax.grad`` of the JAX model's XLA attention
(``repro.models.layers._sdpa``) at the card's bar of the 16-bit gradients
(2e-2 of the largest), and in fp32 to the plain backward.  The turns are
also checked to be a fixed order with one first adder a tile, and a
simulation of blocks taking items in turn, as the persistent grid does,
checks that no order of the turns can leave every block waiting.  Nothing
here reaches a CUDA kernel.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _sdpa
from repro_torch.kernels.ref import (
    attention_mask, ref_flash_attention, ref_flash_attention_bwd, ref_flash_attention_lse,
)

torch.set_num_threads(2)  # several test processes share the cores

SOURCE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / \
    "flash_attention_bwd.cu"
D = 80
SMS = 132  # the H100's SMs: the grid of the persistent dk/dv launch
# (B, H, KV, Sq, Sk, causal, window): GQA with ragged tiles, unmasked (the
# walks rotated), windows causal and not, Sq < Sk, causal Sq > Sk, and more
# items of a kv head than the walk has tiles.
SHAPES = [
    (1, 4, 2, 130, 130, True, 0),
    (1, 4, 4, 300, 300, False, 0),
    (1, 4, 2, 257, 257, True, 64),
    (1, 4, 2, 300, 300, False, 48),
    (1, 2, 2, 100, 300, False, 0),
    (1, 2, 1, 300, 200, True, 0),
    (1, 2, 2, 640, 640, False, 0),
]


def tiles() -> tuple[int, int]:
    """(BM, BN) of the source: keys of an item, query rows of a tile."""
    text = SOURCE.read_text()
    bn = int(re.search(r"constexpr int BN = (\d+);", text).group(1))
    d80 = text[text.index("namespace wg80 {"):]
    bm = int(re.search(r"constexpr int BM = (\d+);", d80).group(1))
    return bm, bn


BM, BN = tiles()


def walk_of(n, N, M, Sk, causal, window, stagger):
    """wg80::walk_of: the tiles [lo, lo + len) item n sees, and its rotation."""
    k0 = n * BM
    k_last = min(k0 + BM, Sk) - 1
    lo = min(M, k0 // BN) if causal else 0
    hi = min(M, (k_last + window - 1) // BN + 1) if window > 0 else M
    ln = max(0, hi - lo)
    rot = n * ln // N if stagger and not causal and ln > 0 else 0
    return lo, ln, rot


def walk(n, N, M, Sk, causal, window, stagger, g):
    """The (query head of the group, tile) of each step of item n, in order."""
    lo, ln, rot = walk_of(n, N, M, Sk, causal, window, stagger)
    return [(j // ln, lo + (j % ln + rot) % ln) for j in range(g * ln)]


def turn_of(n, r, m, N, M, Sk, causal, window, stagger):
    """wg80::turn_of: how many items add their partial of tile m before item n."""
    lo, ln, rot = walk_of(n, N, M, Sk, causal, window, stagger)
    step = r * ln + (m - lo - rot + 2 * ln) % max(ln, 1)
    before = 0
    for n2 in range(N):
        lo2, ln2, rot2 = walk_of(n2, N, M, Sk, causal, window, stagger)
        if n2 == n or not lo2 <= m < lo2 + ln2:
            continue
        if not stagger:
            before += n2 < n
        else:
            step2 = r * ln2 + (m - lo2 - rot2 + 2 * ln2) % ln2
            before += step2 < step or (step2 == step and n2 < n)
    return before


def walked_bwd(q, k, v, do, causal, window, grid=SMS):
    """(dq, dk, dv) in the order of the D = 80 wgmma backward: o and lse as
    the forward gives them, P and dS rounded to q's dtype, dK and dV summed
    in fp32 over each item's walk, each tile's dQ partials added in fp32 in
    the order of their turns, dq and dk scaled once and every gradient
    rounded once."""
    dtype = q.dtype
    B, H, Sq, _ = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    N, M = -(-Sk // BM), -(-Sq // BN)
    stagger = N <= grid
    scale = 1.0 / math.sqrt(D)
    o = ref_flash_attention(q, k, v, causal=causal, window=window)
    lse = ref_flash_attention_lse(q, k, v, causal=causal, window=window)
    delta = (do.float() * o.float()).sum(-1)
    mask = attention_mask(Sq, Sk, causal, window)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dk = torch.zeros(B, KV, Sk, D)
    dv = torch.zeros(B, KV, Sk, D)
    parts: dict = {}
    for b in range(B):
        for kvh in range(KV):
            for n in range(N):
                keys = slice(n * BM, min(n * BM + BM, Sk))
                for r, m in walk(n, N, M, Sk, causal, window, stagger, g):
                    h = kvh * g + r
                    rows = slice(m * BN, min(m * BN + BN, Sq))
                    s = qf[b, h, rows] @ kf[b, kvh, keys].T * scale
                    p = torch.where(mask[rows, keys], torch.exp(s - lse[b, h, rows, None]), 0.0)
                    dp = dof[b, h, rows] @ vf[b, kvh, keys].T
                    ds = p * (dp - delta[b, h, rows, None])
                    p16, ds16 = p.to(dtype).float(), ds.to(dtype).float()
                    dv[b, kvh, keys] += p16.T @ dof[b, h, rows]
                    dk[b, kvh, keys] += ds16.T @ qf[b, h, rows]
                    turn = turn_of(n, r, m, N, M, Sk, causal, window, stagger)
                    parts.setdefault((b, h, m), []).append((turn, ds16 @ kf[b, kvh, keys]))
    dq = torch.zeros(B, H, Sq, D)
    for (b, h, m), adds in parts.items():
        adds.sort(key=lambda a: a[0])
        assert [t for t, _ in adds] == list(range(len(adds))), (b, h, m)
        acc = adds[0][1]  # the first turn stores, the others add
        for _, part in adds[1:]:
            acc = acc + part
        dq[b, h, m * BN:m * BN + acc.shape[0]] = acc
    return (dq * scale).to(dtype), (dk * scale).to(dtype), dv.to(dtype)


def _inputs(seed, B, H, KV, Sq, Sk):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, H, Sq, D), dtype=np.float32))
             for _ in "qd")
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, Sk, D), dtype=np.float32))
            for _ in "kv")
    return q, k, v, do


def _jax_grad_of_sdpa(q, k, v, do, causal, window):
    """jax.grad of the JAX model's ``_sdpa`` (fp32, on the same values) in the
    port's layouts: q, do (B, H, Sq, D); k, v (B, KV, Sk, D)."""
    B, H, Sq, _ = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    to_q = lambda t: jnp.asarray(t.float().numpy().reshape(B, KV, H // KV, Sq, D)
                                 .transpose(0, 3, 1, 2, 4))
    to_k = lambda t: jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3))
    mask = (jnp.asarray(attention_mask(Sq, Sk, causal, window).numpy())
            if causal or window else None)
    dog = to_q(do)
    loss = lambda a, b, c: jnp.sum(_sdpa(a, b, c, mask) * dog)
    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(to_q(q), to_k(k), to_k(v))
    return (np.asarray(dq).transpose(0, 2, 3, 1, 4).reshape(B, H, Sq, D),
            np.asarray(dk).transpose(0, 2, 1, 3), np.asarray(dv).transpose(0, 2, 1, 3))


def test_tiles_are_the_sources():
    assert (BM, BN) == (128, 64)


@pytest.mark.parametrize("grid", [SMS, 2])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,window", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_walked_bwd_matches_jax_grad_of_sdpa(dtype, B, H, KV, Sq, Sk, causal, window, grid):
    """In the kernel's order and roundings, dq, dk and dv stay within the
    card's 16-bit bar (2e-2 of the largest gradient) of jax.grad of the
    reference attention, with the walks staggered (every item of a kv head
    in flight on the H100's 132 SMs) and in the order of n (a grid of 2)."""
    q, k, v, do = (t.to(dtype) for t in _inputs(31, B, H, KV, Sq, Sk))
    got = walked_bwd(q, k, v, do, causal, window, grid)
    want = _jax_grad_of_sdpa(q, k, v, do, causal, window)
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == dtype and g_.shape == w.shape
        err = float(np.abs(g_.float().numpy() - w).max())
        assert err <= 2e-2 * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,window", SHAPES)
def test_walked_bwd_in_fp32_is_the_plain_backward(B, H, KV, Sq, Sk, causal, window):
    """Without the 16-bit roundings the walk, the rotations and the turns only
    reorder fp32 sums: the plain backward within 1e-5."""
    q, k, v, do = _inputs(32, B, H, KV, Sq, Sk)
    o = ref_flash_attention(q, k, v, causal=causal, window=window)
    lse = ref_flash_attention_lse(q, k, v, causal=causal, window=window)
    want = ref_flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    for got, w in zip(walked_bwd(q, k, v, do, causal, window), want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stagger", [True, False])
@pytest.mark.parametrize("Sq,Sk,causal,window", [(4096, 4096, False, 0), (1000, 777, False, 0),
                                                 (1000, 1000, True, 0), (2048, 2048, True, 512),
                                                 (300, 300, False, 48), (100, 1601, False, 0)])
def test_turns_are_a_fixed_order_with_one_first_adder(Sq, Sk, causal, window, stagger):
    """At every query tile, the items that see it hold the turns 0, 1, ...
    once each, so exactly one stores and the rest add, and every tile with
    a row that sees a key is seen (hubert-xlarge's training shape first)."""
    N, M = -(-Sk // BM), -(-Sq // BN)
    seen: dict = {}
    for n in range(N):
        for r, m in walk(n, N, M, Sk, causal, window, stagger, 1):
            seen.setdefault(m, []).append(turn_of(n, r, m, N, M, Sk, causal, window, stagger))
    mask = attention_mask(Sq, Sk, causal, window)
    for m in range(M):
        visible = bool(mask[m * BN:(m + 1) * BN].any())
        assert visible == (m in seen), m
        if visible:
            assert sorted(seen[m]) == list(range(len(seen[m]))), (m, seen[m])


def _run_turns(N, M, g, Sk, causal, window, grid, items_of_heads=2):
    """Blocks x = 0 .. grid - 1 take items x, x + grid, ... (the persistent
    dk/dv grid) and add their partials in their walks' order, each add
    waiting until its tile's counter equals its turn; one item of a kv head
    at a time per block.  Returns the adds made before no block could move."""
    stagger = N <= grid
    items = N * items_of_heads
    todo = []
    for x in range(grid):
        adds = []
        for it in range(x, items, grid):
            head, n = divmod(it, N)
            for r, m in walk(n, N, M, Sk, causal, window, stagger, g):
                adds.append(((head, r, m), turn_of(n, r, m, N, M, Sk, causal, window, stagger)))
        todo.append(adds)
    counters: dict = {}
    done, moved = 0, True
    while moved:
        moved = False
        for adds in todo:
            while adds and counters.get(adds[0][0], 0) == adds[0][1]:
                tile, _ = adds.pop(0)
                counters[tile] = counters.get(tile, 0) + 1
                done += 1
                moved = True
    return done, sum(len(a) for a in todo)


@pytest.mark.parametrize("grid", [1, 2, 3, 5, 8, 132])
@pytest.mark.parametrize("Sq,Sk,g,causal,window", [(1024, 1024, 1, False, 0),
                                                   (1000, 777, 2, False, 0),
                                                   (1024, 1024, 2, True, 0),
                                                   (640, 640, 1, True, 192),
                                                   (640, 640, 1, False, 100)])
def test_turns_never_leave_every_block_waiting(Sq, Sk, g, causal, window, grid):
    """With as many blocks as fit (at most one an SM), walks staggered only
    when every item of a kv head is in flight, every add is made: the
    turns cannot deadlock, on fewer blocks than items included."""
    N, M = -(-Sk // BM), -(-Sq // BN)
    done, left = _run_turns(N, M, g, Sk, causal, window, grid)
    assert left == 0 and done > 0
