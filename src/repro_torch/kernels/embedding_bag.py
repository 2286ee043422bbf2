"""DLRM embedding-bag lookup on Hopper: the wrappers of ``csrc/embedding_bag.cu``
and ``csrc/embedding_bag_bwd.cu``, and :class:`EmbeddingBagFn`, the lookup
with a gradient.

Replaces the Pallas TPU kernel ``repro.kernels.embedding_bag``.  The CUDA
kernel computes the same function (``out[b, t] = sum_j tables[t, idx[b, t,
j]]``, summed in fp32 and rounded to the tables' dtype) on strided tables
and ids of either integer width as they are, clamping and wrapping ids past
the table as the reference's gather does, so nothing here copies or checks
the ids.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.ref_embedding_bag`.

The backward (:func:`embedding_bag_bwd`) writes the dense gradient of the
tables, deterministically and without float atomics; its plain version is
:func:`repro_torch.kernels.ref.ref_embedding_bag_bwd`.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .flash_attention import DTYPE_CODES
from .ref import ref_embedding_bag, ref_embedding_bag_bwd

ID_DTYPES = {torch.int32: 0, torch.int64: 1}


def _entry():
    fn = _build.load("embedding_bag").repro_embedding_bag
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, i, q, i, i, q, q, q, q, q, q, i, i, p]
        fn.restype = i
    return fn


def embedding_bag(tables, indices):
    """tables: (T, R, E) fp32/fp16/bf16; indices: (B, T, NNZ) int32/int64, on
    one CUDA device -> (B, T, E) in the tables' dtype.

    Launches the CUDA kernel once, or raises: this function never computes
    on another path.
    """
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
    out = torch.empty((B, T, E), dtype=tables.dtype, device=tables.device)
    with torch.cuda.device(tables.device):
        err = _entry()(
            tables.data_ptr(), indices.data_ptr(), out.data_ptr(), B, T, R, E, NNZ,
            *tables.stride(), *indices.stride(), DTYPE_CODES[tables.dtype],
            ID_DTYPES[indices.dtype], torch.cuda.current_stream(tables.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"embedding_bag: CUDA error {err} at launch")
    return out


def _bwd_entry():
    fn = _build.load("embedding_bag_bwd").repro_embedding_bag_bwd
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, q, i, q, i, i, q, q, q, i, p]
        fn.restype = i
    return fn


def sorted_keys(indices, R: int):
    """(keys, pos): the int64 key ``t * R + id`` of every entry of ``indices``
    (B, T, NNZ), a negative id wrapped once by R and an id still outside
    [0, R) keyed ``T * R`` (its gradient is dropped, and it sorts last),
    ordered by a stable sort; ``pos`` is each sorted entry's flat position
    ``(b * T + t) * NNZ + j``, so one row's entries come in (b, j) order.

    Index bookkeeping for the backward kernel, not the function it computes:
    the sums are the kernel's.  Nothing here waits for the card."""
    T = indices.shape[1]
    ids = indices.long()
    ids = torch.where(ids < 0, ids + R, ids)
    keys = ids + torch.arange(T, device=ids.device)[None, :, None] * R
    keys = torch.where((ids >= 0) & (ids < R), keys, T * R)
    return torch.sort(keys.reshape(-1), stable=True)


def embedding_bag_bwd(dout, indices, R: int, dtype):
    """dout: (B, T, E) fp32/fp16/bf16; indices: (B, T, NNZ) int32/int64, on
    one CUDA device; R the tables' rows; ``dtype`` the tables' dtype, which
    must be dout's -> dtables (T, R, E): each row the fp32 sum, in (b, j)
    order, of the dout rows whose id selects it, rounded once; zero where no
    id does.  Ids wrap and drop as in :func:`sorted_keys`.

    Launches the CUDA kernel once, or raises: this function never computes
    on another path.
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
    keys, pos = sorted_keys(indices, R)
    dtables = torch.zeros((T, R, E), dtype=dtype, device=dout.device)
    with torch.cuda.device(dout.device):
        err = _bwd_entry()(
            dout.data_ptr(), keys.data_ptr(), pos.data_ptr(), dtables.data_ptr(), keys.numel(),
            T, R, E, NNZ, *dout.stride(), DTYPE_CODES[dtype],
            torch.cuda.current_stream(dout.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"embedding_bag_bwd: CUDA error {err} at launch")
    return dtables


class EmbeddingBagFn(torch.autograd.Function):
    """The lookup with a gradient for the tables (the ids get none).
    ``apply(tables, indices)``: on the card the forward launches
    :func:`embedding_bag` and the backward :func:`embedding_bag_bwd` (counted
    in ``ops.bag_lookup_bwd_launches``); on the CPU they are the plain
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
        dtables = embedding_bag_bwd(dout, indices, ctx.R, ctx.dtype)
        ops.bag_lookup_bwd_launches += 1
        return dtables, None
