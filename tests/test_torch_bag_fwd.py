"""The embedding bag's forward kernel (``csrc/embedding_bag.cu``) on the CPU:
a NumPy emulation of the kernel's work split, on the splits its
``split_of`` takes and on larger units, held bitwise to the sum in j's
order and to the Pallas kernel in interpret mode, and to the plain version
``ref_embedding_bag`` (bitwise up to two ids a bag, within its bars
beyond); and the wrappers' refusal of tensors off the card.

The kernel: a group of L lanes owns a row, each lane 16 bytes (VEC values)
of it at a time; bags taken flat (b * T + t) in units of G; group g of the
grid takes units g, g + groups, ...; a unit's entries (bag k, id j) come in
rounds of L ids, one a lane, handed out by shuffle; Q rows in flight, then
added in j's order from 0 in fp32; a bag's sums stored, rounded once, after
its last id.  What holds the kernel itself, and the units its launch
picks, is the gpu tests in ``tests/test_torch_gpu.py``
(``test_bag_kernel_at_unit_edges``,
``test_bag_kernel_gives_the_same_bits_on_any_unit``).  A change to the
``.cu`` updates the emulation here with it, or deletes it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as pallas_embedding_bag
from repro_torch.kernels.embedding_bag import bag_fwd_split, embedding_bag
from repro_torch.kernels.ref import ref_embedding_bag, ref_embedding_bag_in_order

torch.set_num_threads(2)  # several test processes share the cores


def _split(tables):
    """(VEC, L, Q) as the kernel's ``split_of`` takes them: 16-byte loads
    where the rows are 16-byte aligned with unit element stride (4 rows in
    flight a lane), else one value a lane (8 rows); the fewest lanes, a
    power of two up to 32, that give each a chunk of a row."""
    n = 16 // tables.element_size()
    st_t, st_r, st_e = tables.stride()
    aligned = tables.data_ptr() % 16 == 0 and st_e == 1 and st_t % n == 0 and st_r % n == 0
    vec = n if aligned else 1
    chunks, lanes = -(-tables.shape[-1] // vec), 1
    while lanes < chunks and lanes < 32:
        lanes *= 2
    return vec, lanes, 4 if aligned else 8


def _row_of(raw, R):
    """The kernel's ``row_of``: a negative id wraps by R, then all clamp."""
    raw = int(raw)
    raw = raw + R if raw < 0 else raw
    return min(max(raw, 0), R - 1)


def _walk(tables, ids, split, n_groups: int):
    """The kernel's work split ``split`` (VEC, L, G, Q) in NumPy, for a grid
    of ``n_groups`` groups.  Returns the output (rounded once to the
    tables' dtype) and how many times each bag's columns were stored."""
    T, R, E = tables.shape
    B, _, nnz = ids.shape
    vec, L, G, Q = split
    tab = tables.float().numpy()  # bf16 and fp16 to fp32 exactly
    n_bags = B * T
    n_units = -(-n_bags // G)
    n_chunks = -(-E // vec)
    rounds = -(-n_chunks // L)
    acc_out = np.zeros((n_bags, E), np.float32)
    stores = np.zeros((n_bags, E), np.int64)
    for g in range(n_groups):
        for u in range(g, n_units, n_groups):  # the grid-stride walk
            n_ent = min(G, n_bags - u * G) * nnz
            for r in range(rounds):
                # The round's columns: lane sub's chunk r * L + sub, where active.
                cols = np.arange(r * L * vec, min(E, (r + 1) * L * vec))
                acc = np.zeros(len(cols), np.float32)
                for e0 in range(0, n_ent, L):
                    cnt = min(L, n_ent - e0)
                    lane_row = []  # each lane's id: one load a lane
                    for sub in range(cnt):
                        k, j = divmod(e0 + sub, nnz)
                        b, t = divmod(u * G + k, T)
                        lane_row.append((t, _row_of(ids[b, t, j], R)))
                    k, j = divmod(e0, nnz)
                    for q0 in range(0, cnt, Q):
                        # Q rows in flight (shuffled from lanes q0 + q), then the adds.
                        rows = [tab[lane_row[q0 + q][0], lane_row[q0 + q][1], cols]
                                for q in range(Q) if q0 + q < cnt]
                        for v in rows:
                            acc += v  # in j's order, fp32
                            j += 1
                            if j == nnz:
                                acc_out[u * G + k, cols] = acc
                                stores[u * G + k, cols] += 1
                                acc = np.zeros(len(cols), np.float32)
                                j, k = 0, k + 1
    out = torch.from_numpy(acc_out.reshape(B, T, E)).to(tables.dtype)
    return out, stores


def _inputs(seed, T, R, E, B, nnz, dtype=torch.float32, id_dtype=np.int32):
    rng = np.random.default_rng(seed)
    tables = torch.from_numpy(rng.standard_normal((T, R, E)).astype(np.float32)).to(dtype)
    ids = rng.integers(-R - 3, R + 3, (B, T, nnz)).astype(id_dtype)  # some wrap or clamp
    return tables, ids


def _pallas(tables, ids):
    """The Pallas kernel in interpret mode on the fp32 values of ``tables``,
    ids wrapped and clamped first; its fp32 sums rounded once to the
    tables' dtype."""
    R = tables.shape[1]
    rows = np.clip(np.where(ids < 0, ids + R, ids), 0, R - 1).astype(np.int32)
    out = pallas_embedding_bag(jnp.asarray(tables.float().numpy()), jnp.asarray(rows),
                               interpret=True)
    return torch.from_numpy(np.array(out)).to(tables.dtype)


def _assert_plain(got, tables, ids):
    """Bitwise the plain version where a bag sums at most two ids (two terms
    add the same in any order); beyond, within test_kernels.py's bars of it
    (fp32: rtol 1e-6 and NNZ ulps of the largest term; bf16 2e-2): its CPU
    sum takes another order for some widths."""
    want = ref_embedding_bag(tables, torch.from_numpy(ids))
    nnz = ids.shape[2]
    if nnz <= 2:
        assert torch.equal(got, want)
    elif tables.dtype == torch.float32:
        atol = nnz * np.finfo(np.float32).eps * float(tables.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-6, atol=atol)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# (T, R, E, B, NNZ): B * T at and around the units, the warp's and a block's
# groups; E with a ragged chunk, a scalar row, two rounds of a warp; one bag
# of 9 ids, more than a lane's rows in flight.
WALK_SHAPES = [(1, 30, 128, 7, 1), (1, 30, 128, 9, 1), (3, 30, 16, 3, 1), (2, 20, 64, 17, 1),
               (3, 20, 13, 5, 3), (2, 20, 200, 4, 7), (1, 20, 4, 65, 1), (2, 25, 24, 3, 2),
               (2, 30, 128, 2, 9)]


def _splits(tables, nnz):
    """The kernel's split on units of 1, 2, 3 and its cap, rows // nnz, as
    batches from one to the scoring batch's take them."""
    vec, L, Q = _split(tables)
    return [(vec, L, G, Q) for G in sorted({1, 2, 3, max(1, Q // nnz)})]


@pytest.mark.parametrize("n_groups", [1, 3, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,E,B,nnz", WALK_SHAPES)
def test_kernel_walk_gives_the_plain_bits(T, R, E, B, nnz, dtype, n_groups):
    """Every bag's every column stored once per walk, whatever the grid and
    the unit; bitwise the sum in j's order and the Pallas kernel (which
    adds in that order), and the plain version as ``_assert_plain`` holds
    it."""
    tables, ids = _inputs(T * B + nnz, T, R, E, B, nnz, dtype, np.int64)
    want = ref_embedding_bag_in_order(tables, torch.from_numpy(ids))
    if n_groups == 1:
        assert torch.equal(want, _pallas(tables, ids))
    _assert_plain(want, tables, ids)
    for split in _splits(tables, nnz):
        got, stores = _walk(tables, ids, split, n_groups)
        assert (stores == 1).all()
        assert torch.equal(got, want)


@pytest.mark.parametrize("view", ["columns", "offset"])
def test_kernel_walk_on_strided_tables(view):
    """A column slice keeps 16-byte loads with a scalar tail; a row offset
    by 4 bytes takes one value a lane: the same bits either way."""
    tables, ids = _inputs(3, 2, 30, 16, 11, 2)
    tables = tables[:, :, :13] if view == "columns" else tables[:, :, 1:14]
    for split in _splits(tables, 2):
        assert split[0] == (4 if view == "columns" else 1)
        got, stores = _walk(tables, ids, split, 5)
        assert (stores == 1).all()
        assert torch.equal(got, ref_embedding_bag_in_order(tables, torch.from_numpy(ids)))
        _assert_plain(got, tables, ids)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_walk_multi_hot_is_the_sum_in_j_order(dtype):
    """32 ids a bag (one unit a bag, a round of a warp's ids, four of Q rows):
    bitwise the sum in j's order and the Pallas kernel, which adds in the
    same order (the CPU's plain version sums 32 terms in another)."""
    tables, ids = _inputs(4, 2, 40, 128, 3, 32, dtype)
    vec, L, Q = _split(tables)
    got, stores = _walk(tables, ids, (vec, L, 1, Q), 2)
    assert (stores == 1).all()
    assert torch.equal(got, ref_embedding_bag_in_order(tables, torch.from_numpy(ids)))
    assert torch.equal(got, _pallas(tables, ids))
    _assert_plain(got, tables, ids)


@pytest.mark.parametrize("wrapper", [embedding_bag, bag_fwd_split])
def test_forward_wrappers_refuse_tensors_off_the_card(wrapper):
    """On the CPU the lookup is the plain version's (``EmbeddingBagFn``):
    the kernel's wrappers launch or raise, and never compute elsewhere."""
    tables, ids = _inputs(0, 2, 10, 16, 3, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(tables, torch.from_numpy(ids))
