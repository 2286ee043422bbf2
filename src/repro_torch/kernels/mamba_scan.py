"""Mamba-1 selective scan on Hopper: the wrapper of ``csrc/mamba_scan.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.mamba_scan``.  The CUDA
kernel computes the same function from h = 0 (y in fp32, the final state in
fp32) for any L and DI and for ST up to 128, masking the ragged edges
itself, so nothing here pads.  ``b`` and ``c`` may be the strided slices of
the x_proj output as the Mamba layer makes them: the kernel takes their batch
and time strides.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.ref_mamba_scan`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import DTYPE_CODES

MAX_STATE = 128


def _entry():
    fn = _build.load("mamba_scan").repro_mamba_scan
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, q, q, q, q, i, p]
        fn.restype = i
    return fn


def mamba_scan(xc, dt, a, b, c, d_skip):
    """xc, dt: (B, L, DI); a: (DI, ST); b, c: (B, L, ST); d_skip: (DI,), all on
    one CUDA device -> (y (B, L, DI) fp32, h_final (B, DI, ST) fp32).

    xc, b and c share one dtype (fp32, fp16 or bf16); dt, a and d_skip are
    fp32.  Launches the CUDA kernel once, or raises: this function never
    computes on another path.
    """
    ts = (xc, dt, a, b, c, d_skip)
    if not (xc.is_cuda and all(t.device == xc.device for t in ts)):
        raise ValueError("mamba_scan: every input must lie on one CUDA device")
    if xc.dtype not in DTYPE_CODES or b.dtype != xc.dtype or c.dtype != xc.dtype:
        raise ValueError(
            f"mamba_scan: xc, b, c must share one of {list(DTYPE_CODES)}; "
            f"got {xc.dtype}, {b.dtype}, {c.dtype}"
        )
    if not all(t.dtype == torch.float32 for t in (dt, a, d_skip)):
        raise ValueError("mamba_scan: dt, a and d_skip must be float32")
    if xc.dim() != 3 or a.dim() != 2 or b.dim() != 3 or d_skip.dim() != 1:
        raise ValueError("mamba_scan: xc, dt (B,L,DI), a (DI,ST), b, c (B,L,ST), d_skip (DI,)")
    B, L, DI = xc.shape
    ST = a.shape[1]
    if (dt.shape != xc.shape or a.shape[0] != DI or b.shape != (B, L, ST)
            or c.shape != b.shape or d_skip.shape != (DI,)):
        raise ValueError(
            f"mamba_scan: shapes xc {tuple(xc.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}, c {tuple(c.shape)}, d_skip {tuple(d_skip.shape)}"
        )
    if min(B, L, DI, ST) < 1 or B > 65535 or ST > MAX_STATE:
        raise ValueError(f"mamba_scan: B={B}, L={L}, DI={DI}, ST={ST} out of range")
    xc, dt, a, d_skip = (t.contiguous() for t in (xc, dt, a, d_skip))
    b, c = (t if t.stride(2) == 1 else t.contiguous() for t in (b, c))
    y = torch.empty((B, L, DI), dtype=torch.float32, device=xc.device)
    h = torch.empty((B, DI, ST), dtype=torch.float32, device=xc.device)
    with torch.cuda.device(xc.device):
        err = _entry()(
            xc.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            d_skip.data_ptr(), y.data_ptr(), h.data_ptr(), B, L, DI, ST,
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            DTYPE_CODES[xc.dtype], torch.cuda.current_stream(xc.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"mamba_scan: CUDA error {err} at launch")
    return y, h
