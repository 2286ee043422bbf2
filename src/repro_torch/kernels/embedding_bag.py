"""DLRM embedding-bag lookup on Hopper: the wrapper of ``csrc/embedding_bag.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.embedding_bag``.  The CUDA
kernel computes the same function (``out[b, t] = sum_j tables[t, idx[b, t,
j]]``, summed in fp32 and rounded to the tables' dtype) on strided tables
and ids of either integer width as they are, clamping and wrapping ids past
the table as the reference's gather does, so nothing here copies or checks
the ids.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.ref_embedding_bag`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import DTYPE_CODES

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
