"""DLRM embedding-bag lookup on Hopper: the wrappers of ``csrc/embedding_bag.cu``
and ``csrc/embedding_bag_bwd.cu``, and :class:`EmbeddingBagFn`, the lookup
with a gradient.

Replaces the Pallas TPU kernel ``repro.kernels.embedding_bag``.  The CUDA
kernel computes the same function (``out[b, t] = sum_j tables[t, idx[b, t,
j]]``, summed in fp32 in j's order and rounded to the tables' dtype) on
strided tables and ids of either integer width as they are, clamping and
wrapping ids past the table as the reference's gather does, so nothing here
copies or checks the ids.  A group of lanes takes units of consecutive
bags at a time (:func:`bag_fwd_split` says how many), several rows a lane
in flight.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.ref_embedding_bag`.

The backward (:func:`embedding_bag_bwd`) writes the dense gradient of the
tables, deterministically and without float atomics, on one of two tilings
that :func:`bag_bwd_tiling` picks by the number of entries: ``small`` (one
launch, no sort) or ``sorted`` (the keys' stable sort, then the kernel).
Its plain version is :func:`repro_torch.kernels.ref.ref_embedding_bag_bwd`.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._build import sm_count
from .flash_attention import DTYPE_CODES
from .ref import ref_embedding_bag, ref_embedding_bag_bwd

ID_DTYPES = {torch.int32: 0, torch.int64: 1}


def _entry(name: str = "repro_embedding_bag"):
    fn = getattr(_build.load("embedding_bag"), name)
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "repro_embedding_bag":
            fn.argtypes = [p, p, p, i, i, q, i, i, i, q, q, q, q, q, q, i, i, p]
        else:
            fn.argtypes = [p, i, i, q, q, q, q, i, i, p]
        fn.restype = i
    return fn


def _check(tables, indices):
    if not (tables.is_cuda and indices.device == tables.device):
        raise ValueError("embedding_bag: tables and indices must lie on one CUDA device")
    if tables.dtype not in DTYPE_CODES:
        raise ValueError(f"embedding_bag: tables must be one of {list(DTYPE_CODES)}; "
                         f"got {tables.dtype}")
    if indices.dtype not in ID_DTYPES:
        raise ValueError(f"embedding_bag: indices must be one of {list(ID_DTYPES)}; "
                         f"got {indices.dtype}")
    if tables.dim() != 3 or indices.dim() != 3 or indices.shape[1] != tables.shape[0]:
        raise ValueError(f"embedding_bag: tables (T,R,E) and indices (B,T,NNZ); got "
                         f"{tuple(tables.shape)}, {tuple(indices.shape)}")
    T, R, E = tables.shape
    B, _, NNZ = indices.shape
    if min(B, T, R, E, NNZ) < 1 or max(B, T, E, NNZ) > 2**31 - 1:
        raise ValueError(f"embedding_bag: B={B}, T={T}, R={R}, E={E}, NNZ={NNZ} out of range")


def embedding_bag(tables, indices):
    """tables: (T, R, E) fp32/fp16/bf16; indices: (B, T, NNZ) int32/int64, on
    one CUDA device -> (B, T, E) in the tables' dtype.

    Launches the CUDA kernel once, or raises: this function never computes
    on another path.
    """
    _check(tables, indices)
    T, R, E = tables.shape
    B, _, NNZ = indices.shape
    out = torch.empty((B, T, E), dtype=tables.dtype, device=tables.device)
    with torch.cuda.device(tables.device):
        err = _entry()(
            tables.data_ptr(), indices.data_ptr(), out.data_ptr(), B, T, R, E, NNZ,
            sm_count(tables.device.index), *tables.stride(), *indices.stride(),
            DTYPE_CODES[tables.dtype], ID_DTYPES[indices.dtype],
            torch.cuda.current_stream(tables.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"embedding_bag: CUDA error {err} at launch")
    return out


def bag_fwd_split(tables, indices) -> dict:
    """How :func:`embedding_bag` splits this lookup on its card (the
    kernel's own ``split_of``): ``vec`` values a lane loads at a time,
    ``lanes`` a row, ``unit`` consecutive bags (flat ``b * T + t``) a group
    of lanes takes at a time and ``rows`` in flight a lane.  Launches
    nothing."""
    _check(tables, indices)
    T, _, E = tables.shape
    B, _, NNZ = indices.shape
    split = (ctypes.c_int * 4)()
    err = _entry("repro_embedding_bag_split")(
        tables.data_ptr(), E, NNZ, B * T, *tables.stride(), DTYPE_CODES[tables.dtype],
        sm_count(tables.device.index), split,
    )
    if err:
        raise RuntimeError(f"bag_fwd_split: error {err}")
    return dict(zip(("vec", "lanes", "unit", "rows"), split))


# Entries (B * T * NNZ) up to which the backward's `small` tiling serves:
# csrc/embedding_bag_bwd.cu's N_SMALL, the most keys a block stages with
# their hash slots in shared memory (the source derives it).
N_SMALL = 8192
BWD_TILINGS = ("small", "sorted")


def bag_bwd_tiling(n: int) -> str:
    """The tiling of :func:`embedding_bag_bwd` for n = B * T * NNZ entries:
    ``"small"`` (one launch, no sort) up to ``N_SMALL``, ``"sorted"`` (a
    stable sort of the keys, then a warp per 32 sorted entries) above."""
    return "small" if n <= N_SMALL else "sorted"


def _bwd_entry(tiling: str):
    fn = getattr(_build.load("embedding_bag_bwd"), f"repro_embedding_bag_bwd_{tiling}")
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if tiling == "small":
            fn.argtypes = [p, p, i, p, i, i, q, i, i, q, q, q, q, q, q, i, p]
        else:
            fn.argtypes = [p, p, i, p, p, q, i, q, i, i, q, q, q, i, p]
        fn.restype = i
    return fn


def _keys_entry():
    fn = _build.load("embedding_bag_bwd").repro_embedding_bag_keys
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, i, q, i, q, i, q, q, q, p]
        fn.restype = i
    return fn


def key_dtype(T: int, R: int) -> torch.dtype:
    """The narrowest key type that holds ``T * R``, the dropped ids' key:
    int32 (half the radix sort's passes) or int64."""
    return torch.int32 if T * R <= 2**31 - 1 else torch.int64


def sorted_keys(indices, R: int):
    """(keys, pos): the key ``t * R + id`` of every entry of ``indices`` (B,
    T, NNZ) in :func:`key_dtype` ``(T, R)``, a negative id wrapped once by R
    and an id still outside [0, R) keyed ``T * R`` (its gradient is dropped,
    and it sorts last), ordered by a stable sort;
    ``pos`` is each sorted entry's flat position ``(b * T + t) * NNZ + j``
    (int64), so one row's entries come in (b, j) order.

    Index bookkeeping for the ``sorted`` tiling, not the function it
    computes: the sums are the kernel's.  On a CUDA device the keys come
    from one pass of ``embedding_bag_keys_kernel``; on the CPU from the
    same steps in PyTorch.  Nothing here waits for the card."""
    B, T, NNZ = indices.shape
    dtype = key_dtype(T, R)
    if indices.device.type == "cpu":
        ids = indices.long()
        ids = torch.where(ids < 0, ids + R, ids)
        keys = ids + torch.arange(T, device=ids.device)[None, :, None] * R
        keys = torch.where((ids >= 0) & (ids < R), keys, T * R).reshape(-1).to(dtype)
    else:
        if not indices.is_cuda:
            raise ValueError("sorted_keys: indices must lie on the CPU or a CUDA device")
        keys = torch.empty(indices.numel(), dtype=dtype, device=indices.device)
        with torch.cuda.device(indices.device):
            err = _keys_entry()(
                indices.data_ptr(), ID_DTYPES[indices.dtype], keys.data_ptr(), ID_DTYPES[dtype],
                keys.numel(), T, R, NNZ, *indices.stride(),
                torch.cuda.current_stream(indices.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"sorted_keys: CUDA error {err} at launch")
    return torch.sort(keys, stable=True)


def embedding_bag_bwd(dout, indices, R: int, dtype, tiling: str | None = None):
    """dout: (B, T, E) fp32/fp16/bf16; indices: (B, T, NNZ) int32/int64, on
    one CUDA device; R the tables' rows; ``dtype`` the tables' dtype, which
    must be dout's -> dtables (T, R, E): each row the fp32 sum, in (b, j)
    order, of the dout rows whose id selects it, rounded once; zero where no
    id does.  Ids wrap and drop as in :func:`sorted_keys`.

    ``tiling`` defaults to :func:`bag_bwd_tiling`'s choice; ``"small"``
    above ``N_SMALL`` entries raises.  Both tilings give the same bits.
    Zeroes dtables and launches the chosen kernel (``sorted``: after its
    keys and their sort), or raises: this function never computes on
    another path.
    """
    if not (dout.is_cuda and indices.device == dout.device):
        raise ValueError("embedding_bag_bwd: dout and indices must lie on one CUDA device")
    if dout.dtype not in DTYPE_CODES or dtype != dout.dtype:
        raise ValueError(f"embedding_bag_bwd: dout must be one of {list(DTYPE_CODES)} and "
                         f"the tables' dtype; got {dout.dtype} for {dtype} tables")
    if indices.dtype not in ID_DTYPES:
        raise ValueError(f"embedding_bag_bwd: indices must be one of {list(ID_DTYPES)}; "
                         f"got {indices.dtype}")
    if dout.dim() != 3 or indices.dim() != 3 or indices.shape[:2] != dout.shape[:2]:
        raise ValueError(f"embedding_bag_bwd: dout (B,T,E) and indices (B,T,NNZ); got "
                         f"{tuple(dout.shape)}, {tuple(indices.shape)}")
    B, T, E = dout.shape
    NNZ = indices.shape[2]
    if min(B, T, R, E, NNZ) < 1 or max(T, E, NNZ) > 2**31 - 1:
        raise ValueError(f"embedding_bag_bwd: B={B}, T={T}, R={R}, E={E}, NNZ={NNZ} out of "
                         "range")
    n = B * T * NNZ
    tiling = tiling or bag_bwd_tiling(n)
    if tiling not in BWD_TILINGS or (tiling == "small" and n > N_SMALL):
        raise ValueError(f"embedding_bag_bwd: tiling {tiling!r} does not take {n} entries "
                         f"(small: up to {N_SMALL})")
    stream = torch.cuda.current_stream(dout.device).cuda_stream
    if tiling == "small":
        dtables = torch.zeros((T, R, E), dtype=dtype, device=dout.device)
        with torch.cuda.device(dout.device):
            err = _bwd_entry("small")(
                dout.data_ptr(), indices.data_ptr(), ID_DTYPES[indices.dtype],
                dtables.data_ptr(), B, T, R, E, NNZ, *indices.stride(), *dout.stride(),
                DTYPE_CODES[dtype], stream,
            )
    else:
        keys, pos = sorted_keys(indices, R)
        dtables = torch.zeros((T, R, E), dtype=dtype, device=dout.device)
        with torch.cuda.device(dout.device):
            err = _bwd_entry("sorted")(
                dout.data_ptr(), keys.data_ptr(), ID_DTYPES[keys.dtype], pos.data_ptr(),
                dtables.data_ptr(), n, T, R, E, NNZ, *dout.stride(), DTYPE_CODES[dtype], stream,
            )
    if err:
        raise RuntimeError(f"embedding_bag_bwd ({tiling}): CUDA error {err} at launch")
    return dtables


class EmbeddingBagFn(torch.autograd.Function):
    """The lookup with a gradient for the tables (the ids get none).
    ``apply(tables, indices)``: on the card the forward launches
    :func:`embedding_bag` and the backward :func:`embedding_bag_bwd` on
    :func:`bag_bwd_tiling`'s choice (counted in ``ops.bag_lookup_bwd_launches``
    and, by tiling, ``ops.bag_lookup_bwd_small_launches`` or
    ``ops.bag_lookup_bwd_sorted_launches``); on the CPU they are the plain
    versions, which follow the same id rules.  Saves only the ids, never the
    tables."""

    @staticmethod
    def forward(ctx, tables, indices):
        ctx.save_for_backward(indices)
        ctx.R, ctx.dtype = tables.shape[1], tables.dtype
        if tables.device.type == "cpu":
            return ref_embedding_bag(tables, indices)
        return embedding_bag(tables, indices)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        from . import ops  # the launch counters; ops imports this module

        (indices,) = ctx.saved_tensors
        if dout.device.type == "cpu":
            return ref_embedding_bag_bwd(dout, indices, ctx.R, ctx.dtype), None
        tiling = bag_bwd_tiling(indices.numel())
        dtables = embedding_bag_bwd(dout, indices, ctx.R, ctx.dtype, tiling)
        ops.bag_lookup_bwd_launches += 1
        if tiling == "small":
            ops.bag_lookup_bwd_small_launches += 1
        else:
            ops.bag_lookup_bwd_sorted_launches += 1
        return dtables, None
