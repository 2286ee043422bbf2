"""The embedding bag's backward tilings (``kernels.embedding_bag``) on the CPU:
``bag_bwd_tiling`` around ``N_SMALL``, and NumPy emulations of the two CUDA
kernels' index logic (``csrc/embedding_bag_bwd.cu``), held bitwise to the
plain version ``ref_embedding_bag_bwd`` and within its bars to ``jax.vjp``
of the reference's lookup ``repro.kernels.ref.ref_embedding_bag``.

``small``: a group of L lanes per entry of a table; it owns its row when no
earlier entry of the table has its key (a scan of the staged keys L at a
time, from the first entry of the key's hash slot), and walks the later
entries with the key in (b, j) order (up to the slot's last entry).
``sorted``: a warp per 32 sorted entries; run starts by ballot, group g
takes starts g, g + 32 / L, ...; the last run walks past the chunk's end, L
entries a step.  Both add in fp32 in (b, j) order, as the plain version's
``index_add_`` does on the CPU, so the bits agree.

The emulations copy the kernels' algorithm; what holds the kernels
themselves is the gpu tests in ``tests/test_torch_gpu.py``
(``test_bag_bwd_tilings_agree_bitwise`` and, per tiling,
``test_bag_bwd_kernel_matches_plain``).  A change to the ``.cu`` updates the
emulations here with it, or deletes them."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels.embedding_bag import N_SMALL, bag_bwd_tiling, key_dtype, sorted_keys
from repro_torch.kernels.ref import ref_embedding_bag_bwd

torch.set_num_threads(2)  # several test processes share the cores

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "src/repro_torch/csrc/embedding_bag_bwd.cu").read_text()
T, R, E = 3, 100, 8


def test_bag_bwd_tiling_at_the_small_boundary():
    assert [bag_bwd_tiling(n) for n in (N_SMALL - 1, N_SMALL, N_SMALL + 1)] == \
        ["small", "small", "sorted"]
    assert bag_bwd_tiling(1) == "small"
    # The training batch (B=128, T=2, NNZ=1) and B=128 over the paper's 64 tables.
    assert bag_bwd_tiling(128 * 2) == bag_bwd_tiling(128 * 64) == "small"
    assert bag_bwd_tiling(4096 * 2 * 32) == "sorted"  # the hot multi-hot case


def test_n_small_is_the_kernels():
    """The wrapper's N_SMALL is the one the CUDA source sizes its shared memory by."""
    assert int(re.search(r"constexpr int N_SMALL = (\d+);", SRC).group(1)) == N_SMALL


def _ids(rng, kind, B, nnz, id_dtype):
    """(B, T, nnz) ids: drawn from 8 of the R rows (rows repeat); from 3
    rows (runs of B * nnz / 3, longer than a warp's 32); or from [-2R, 2R),
    so some lie past the table, some wrap and some wrap to below 0."""
    if kind == "duplicates":
        ids = rng.choice(rng.choice(R, 8, replace=False), (B, T, nnz))
    elif kind == "hot":
        ids = rng.choice(rng.choice(R, 3, replace=False), (B, T, nnz))
    else:
        ids = rng.integers(-2 * R, 2 * R, (B, T, nnz))
    return ids.astype(id_dtype)


def _slot(key, hbits):
    """``slot_of`` in the kernel: a multiplicative hash in uint32 arithmetic."""
    x = (int(key) & 0xFFFFFFFF) ^ ((int(key) >> 32) & 0xFFFFFFFF)
    return ((x * 2654435761) & 0xFFFFFFFF) >> (32 - hbits)


def test_key_dtype_holds_the_dropped_key():
    """int32 keys (half the radix sort's passes) wherever T * R fits: the
    training run's 2 x 1e7 rows and the paper's 64 x 1e7 (6.4e8)."""
    assert key_dtype(2, 10**7) == key_dtype(64, 10**7) == torch.int32
    assert key_dtype(1, 2**31 - 1) == torch.int32
    assert key_dtype(2, 2**30) == key_dtype(1, 2**31) == torch.int64


@pytest.mark.parametrize("R_", [R, 2**31 + 8])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_sorted_keys_take_the_narrowest_key_type(id_dtype, R_):
    """``sorted_keys`` keys in ``key_dtype(T, R)``: int32 for R = 100, int64
    for a table past INT_MAX (T * R = 6.4e9); the keys are ``t * R + id``
    after the wrap, ``T * R`` for a dropped id, in a stable order."""
    raw = _ids(np.random.default_rng(2), "out_of_range", 40, 5, np.int64)
    if R_ > R:  # ids within a few rows of R_ (of 2^31 - 1 for int32 ids)
        shift = R_ - R if id_dtype == np.int64 else 2**31 - 1 - 2 * R
        raw = np.where(raw >= 0, raw + shift, raw)
    ids = torch.from_numpy(raw.astype(id_dtype))
    keys, pos = sorted_keys(ids, R_)
    assert keys.dtype == key_dtype(T, R_) and pos.dtype == torch.int64
    wrapped = np.where(raw < 0, raw + R_, raw)
    want = np.where((wrapped >= 0) & (wrapped < R_), wrapped + np.arange(T)[None, :, None] * R_,
                    T * R_).reshape(-1)
    order = np.argsort(want, kind="stable")
    assert np.array_equal(keys.long().numpy(), want[order])
    assert np.array_equal(pos.numpy(), order)


def _constant(ctype, name):
    """A constant of the CUDA source written as an integer or a product of
    integer literals (``227 * 1024``)."""
    expr = re.search(rf"constexpr {ctype} {name} = ([^;]+);", SRC).group(1)
    factors = [f.strip() for f in expr.split("*")]
    assert all(re.fullmatch(r"\d+", f) for f in factors), f"{name} = {expr}"
    return int(np.prod([int(f) for f in factors]))


def _hbits(m):
    """The small kernel's 2^hbits hash slots for m staged keys: at least
    SLOTS_PER_KEY * m, fewer where m int64 keys and two int arrays of slots
    would pass MAX_SMEM bytes, never fewer than m (the source's constants)."""
    slots_per_key = _constant("int", "SLOTS_PER_KEY")
    max_smem = _constant("size_t", "MAX_SMEM")
    hbits = 1
    while (1 << hbits) < slots_per_key * m:
        hbits += 1
    while hbits > 1 and (1 << (hbits - 1)) >= m and 8 * m + 8 * (1 << hbits) > max_smem:
        hbits -= 1
    return hbits


def test_small_tilings_hash_fits_shared_memory():
    """Two slots a key, up to N_SMALL keys (8192 keys and 16384 slots: 192 KB
    of the 227 KB a block may use); twice N_SMALL would not fit even at one
    slot a key (16 bytes a key)."""
    assert [1 << _hbits(m) for m in (1, 128, 4096, N_SMALL)] == [2, 256, 8192, 16384]
    assert 8 * N_SMALL + 8 * (1 << _hbits(N_SMALL)) <= 227 * 1024 < 16 * 2 * N_SMALL


def _small_walk(ids, dout, L):
    """The ``small`` kernel's algorithm in NumPy, lane for lane of a group of
    L: keys staged per table in (b, j) order (-1 dropped), with the first
    and last entry of each hash slot (2^hbits >= m slots); an entry owns its
    row when a ballot over the keys in [first, i), L at a time, finds none
    equal; the owner adds its own row, then walks (i, last] in ballot
    (ascending lane) order."""
    B, _, nnz = ids.shape
    d = dout.float().numpy()
    out = np.zeros((T, R, dout.shape[-1]), np.float32)
    m, lanes = B * nnz, np.arange(L)
    hbits = _hbits(m)
    for t in range(T):
        skey = ids[:, t, :].reshape(-1).astype(np.int64)
        skey = np.where(skey < 0, skey + R, skey)
        skey = np.where((skey >= 0) & (skey < R), skey, -1)
        first, last = {}, {}
        for k, key in enumerate(skey):
            if key >= 0:
                h = _slot(key, hbits)
                first[h], last[h] = min(first.get(h, k), k), max(last.get(h, k), k)
        for i in range(m):
            key = skey[i]
            if key < 0:
                continue
            f, l = first[_slot(key, hbits)], last[_slot(key, hbits)]
            earlier = any(((k >= f) & (k < i) & (skey[np.minimum(k, m - 1)] == key)).any()
                          for k in (c + lanes for c in range(f - f % L, i if f < i else 0, L)))
            if earlier:
                continue
            acc = np.zeros(dout.shape[-1], np.float32)
            acc += d[i // nnz, t]
            for c in range((i + 1) - (i + 1) % L, l + 1 if i < l else 0, L):
                k = c + lanes
                hits = (k > i) & (k <= l) & (skey[np.minimum(k, m - 1)] == key)
                for idx in k[hits]:  # __ffs order: ascending lanes
                    acc += d[idx // nnz, t]
            out[t, key] = acc
    return torch.from_numpy(out).to(dout.dtype)


def _sorted_walk(ids, dout, L):
    """The ``sorted`` kernel's algorithm in NumPy over ``sorted_keys``: a warp
    per 32 sorted entries, runs starting where the key changes, group g
    taking starts g, g + 32 / L, ...; the chunk's last run goes on past its
    end L entries a step, whose matches form a prefix.  Returns the gradient
    and how many runs crossed a chunk's end."""
    keys, pos = (a.numpy() for a in sorted_keys(torch.from_numpy(ids), R))
    nnz, n, n_rows = ids.shape[2], len(keys), T * R
    d = dout.float().numpy()
    out = np.zeros((n_rows, dout.shape[-1]), np.float32)

    def row(p):
        b, t = divmod(int(p) // nnz, T)
        return d[b, t]

    def at(a, k, fill):
        return np.where(k < n, a[np.minimum(k, n - 1)], fill)

    crossed = 0
    for base in range(0, n, 32):
        k = base + np.arange(32)
        key, spos = at(keys, k, n_rows), at(pos, k, 0)
        prev = np.concatenate([[keys[base - 1] if base else -1], key[:-1]])
        change = key != prev
        starts = np.flatnonzero(change & (key < n_rows))
        for g in range(32 // L):
            for s in starts[g::32 // L]:
                later = np.flatnonzero(change[s + 1:])
                end = s + 1 + later[0] if len(later) else 32
                acc = np.zeros(dout.shape[-1], np.float32)
                for u in range(s, end):
                    acc += row(spos[u])
                c = base + 32
                while end == 32:
                    kk = c + np.arange(L)
                    hits = at(keys, kk, n_rows) == key[s]
                    cnt = int(hits.sum())
                    assert hits[:cnt].all()  # sorted: the run's entries are a prefix
                    for p in at(pos, kk, 0)[:cnt]:
                        acc += row(p)
                    crossed += c == base + 32 and cnt > 0
                    if cnt < L:
                        break
                    c += L
                out[key[s]] = acc
    return torch.from_numpy(out.reshape(T, R, -1)).to(dout.dtype), crossed


def _jax_grad(ids, dout):
    f = lambda t: jref.ref_embedding_bag(t, jnp.asarray(ids))  # noqa: E731
    _, vjp = jax.vjp(f, jnp.zeros((T, R, dout.shape[-1]), jnp.float32))
    return np.asarray(vjp(jnp.asarray(dout.float().numpy()))[0])


def _check(got, ids, dout):
    """Bitwise the plain version; within its bars of ``jax.vjp`` (fp32: rtol
    1e-6 and (the longest run) ulps of max|dout|; bf16: 2e-2)."""
    assert torch.equal(got, ref_embedding_bag_bwd(dout, torch.from_numpy(ids), R, dout.dtype))
    want = _jax_grad(ids, dout)
    if dout.dtype == torch.float32:
        keys = np.where(ids < 0, ids + R, ids) + np.arange(T)[None, :, None] * R
        longest = int(np.unique(keys, return_counts=True)[1].max())
        atol = longest * np.finfo(np.float32).eps * float(dout.abs().max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def _inputs(kind, id_dtype, dtype, B=40, nnz=5, seed=0):
    rng = np.random.default_rng(seed + len(kind))
    ids = _ids(rng, kind, B, nnz, id_dtype)
    dout = torch.from_numpy(rng.standard_normal((B, T, E)).astype(np.float32)).to(dtype)
    return ids, dout


@pytest.mark.parametrize("L", [4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", ["duplicates", "hot", "out_of_range"])
def test_small_tilings_walk_gives_the_plain_bits(kind, id_dtype, dtype, L):
    ids, dout = _inputs(kind, id_dtype, dtype)
    _check(_small_walk(ids, dout, L), ids, dout)


@pytest.mark.parametrize("L", [4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", ["duplicates", "hot", "out_of_range"])
def test_sorted_tilings_chunked_walk_gives_the_plain_bits(kind, id_dtype, dtype, L):
    ids, dout = _inputs(kind, id_dtype, dtype)
    got, crossed = _sorted_walk(ids, dout, L)
    if kind != "out_of_range":
        assert crossed > 0  # runs of 8 or 3 rows a table cross a chunk's end
    _check(got, ids, dout)


@pytest.mark.parametrize("tiling", ["small", "sorted"])
def test_tilings_agree_at_one_id_a_bag(tiling):
    """One id a bag (the training batch's shape), every id distinct or out of
    range: each row is one dout row, and both walks write it as it is."""
    rng = np.random.default_rng(5)
    ids = np.stack([rng.permutation(2 * R)[:30] for _ in range(T)], 1)[:, :, None]
    dout = torch.from_numpy(rng.standard_normal((30, T, E)).astype(np.float32))
    got = _small_walk(ids, dout, 32) if tiling == "small" else _sorted_walk(ids, dout, 32)[0]
    _check(got, ids, dout)
