"""RG-LRU linear recurrence on Hopper: the wrappers of ``csrc/rglru_scan.cu``
and ``csrc/rglru_scan_bwd.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.rglru_scan``.  The CUDA
kernel computes the same function (``h_t = a_t * h_{t-1} + b_t`` from
h = 0, in fp32) for any L and D, masking the ragged edges itself, so nothing
here pads.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.ref_rglru_scan`.

Training: :func:`rglru_scan_bwd` wraps the backward kernel, which gives da
and db from a, h_all and the cotangents of h_all and h_final.  Both kernels
are one launch that reads every input once: a block walks its channels'
time in rounds, its warps each a chunk of steps, the carries across chunks
composed in a fixed order (no float atomics, the same bits every launch).
The backward's plain version is
:func:`repro_torch.kernels.ref.ref_rglru_scan_bwd`.  :class:`LruScanFn`
joins the forward and the backward for autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .flash_attention import DTYPE_CODES, on_card
from .ref import ref_rglru_scan, ref_rglru_scan_bwd


def _entry():
    fn = _build.load("rglru_scan").repro_rglru_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = i
    return fn


def rglru_scan(a, b):
    """a, b: (B, L, D) of one dtype on one CUDA device ->
    (h_all (B, L, D) fp32, h_final (B, D) fp32).

    Launches the CUDA kernel once, or raises: this function never computes
    on another path.
    """
    if not (on_card(a) and b.device == a.device):
        raise ValueError("rglru_scan: a and b must lie on one CUDA device")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(
            f"rglru_scan: a and b must share one of {list(DTYPE_CODES)}; got {a.dtype}, {b.dtype}"
        )
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a and b (B,L,D); got {tuple(a.shape)}, {tuple(b.shape)}")
    B, L, D = a.shape
    if min(B, L, D) < 1 or B > 65535:
        raise ValueError(f"rglru_scan: B={B}, L={L}, D={D} out of range")
    a, b = a.contiguous(), b.contiguous()
    return tuple((_launch if a.is_cuda else torch.ops.repro.rglru_scan)(a, b))


def _lru_outputs(a) -> list[torch.Tensor]:
    B, L, D = a.shape
    return [torch.empty((B, L, D), dtype=torch.float32, device=a.device),
            torch.empty((B, D), dtype=torch.float32, device=a.device)]


def _launch(a: torch.Tensor, b: torch.Tensor) -> list[torch.Tensor]:
    """The forward kernel's launch on checked, contiguous inputs -> [h_all,
    h_final]: the CUDA implementation of ``repro::rglru_scan``."""
    B, L, D = a.shape
    h_all, h_fin = _lru_outputs(a)
    with torch.cuda.device(a.device):
        err = _entry()(
            a.data_ptr(), b.data_ptr(), h_all.data_ptr(), h_fin.data_ptr(), B, L, D,
            DTYPE_CODES[a.dtype], torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"rglru_scan: CUDA error {err} at launch")
    return [h_all, h_fin]


_fwd_op = torch.library.custom_op("repro::rglru_scan", _launch, mutates_args=(),
                                  device_types="cuda")


@_fwd_op.register_fake
def _(a, b):
    return _lru_outputs(a)


def _bwd_entry():
    fn = _build.load("rglru_scan_bwd").repro_rglru_scan_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i, i, i, i, p]
        fn.restype = i
    return fn


def rglru_scan_bwd(a, h_all, dh_all, dh_final=None):
    """The scan's gradient on the card: the forward's ``a`` (B, L, D; fp32,
    fp16 or bf16), its h_all (B, L, D) fp32, the cotangent dh_all (B, L, D)
    fp32 and dh_final (B, D) fp32 or None (0), all on one CUDA device ->
    (da, db) in a's dtype (b shares it), the function of
    :func:`repro_torch.kernels.ref.ref_rglru_scan_bwd`.

    Launches the backward kernel once on the current stream, or raises: this
    function never computes on another path.
    """
    ts = (a, h_all, dh_all) + (() if dh_final is None else (dh_final,))
    if not (on_card(a) and all(t.device == a.device for t in ts)):
        raise ValueError("rglru_scan_bwd: every input must lie on one CUDA device")
    if a.dtype not in DTYPE_CODES:
        raise ValueError(f"rglru_scan_bwd: a must be one of {list(DTYPE_CODES)}; got {a.dtype}")
    if a.dim() != 3:
        raise ValueError(f"rglru_scan_bwd: a (B,L,D); got {tuple(a.shape)}")
    B, L, D = a.shape
    if min(B, L, D) < 1 or B > 65535:
        raise ValueError(f"rglru_scan_bwd: B={B}, L={L}, D={D} out of range")
    for name, t, shape in (("h_all", h_all, (B, L, D)), ("dh_all", dh_all, (B, L, D)),
                           ("dh_final", dh_final, (B, D))):
        if t is not None and (t.dtype != torch.float32 or t.shape != shape):
            raise ValueError(f"rglru_scan_bwd: {name} must be float32 {shape}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    a, h_all, dh_all = a.contiguous(), h_all.contiguous(), dh_all.contiguous()
    dh_final = None if dh_final is None else dh_final.contiguous()
    launch = _launch_bwd if a.is_cuda else torch.ops.repro.rglru_scan_bwd
    return tuple(launch(a, h_all, dh_all, dh_final))


def _launch_bwd(a: torch.Tensor, h_all: torch.Tensor, dh_all: torch.Tensor,
                dh_final: Optional[torch.Tensor]) -> list[torch.Tensor]:
    """The backward kernel's launch on checked, contiguous inputs -> [da, db]
    in a's dtype (the kernel writes them in fp32): the CUDA implementation
    of ``repro::rglru_scan_bwd``."""
    B, L, D = a.shape
    dev = a.device
    da = torch.empty((B, L, D), dtype=torch.float32, device=dev)
    db = torch.empty((B, L, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _bwd_entry()(
            a.data_ptr(), h_all.data_ptr(), dh_all.data_ptr(),
            0 if dh_final is None else dh_final.data_ptr(), da.data_ptr(), db.data_ptr(),
            B, L, D, DTYPE_CODES[a.dtype], torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"rglru_scan_bwd: CUDA error {err} at launch")
    return [da.to(a.dtype), db.to(a.dtype)]


_bwd_op = torch.library.custom_op("repro::rglru_scan_bwd", _launch_bwd, mutates_args=(),
                                  device_types="cuda")


@_bwd_op.register_fake
def _(a, h_all, dh_all, dh_final):
    return [torch.empty_like(a), torch.empty_like(a)]


class LruScanFn(torch.autograd.Function):
    """The RG-LRU scan with a gradient.  ``apply(a, b)`` -> (h_all, h_final):
    on the card the forward launches :func:`rglru_scan` and the backward
    launches :func:`rglru_scan_bwd` once (counted in
    ``ops.lru_scan_bwd_launches``); on the CPU both are the plain versions.
    Saves ``a`` and h_all, the output it already writes: nothing that remat
    does not drop with the forward.  An unused output's gradient arrives as
    None and counts as 0."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.set_materialize_grads(False)
        h_all, h_fin = (ref_rglru_scan if a.device.type == "cpu" else rglru_scan)(a, b)
        ctx.save_for_backward(a, h_all)
        return h_all, h_fin

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_all, dh_final):
        from . import ops  # the launch counter; ops imports this module

        a, h_all = ctx.saved_tensors
        if dh_all is None:
            dh_all = torch.zeros(h_all.shape, dtype=torch.float32, device=a.device)
        if a.device.type == "cpu":
            da, db = ref_rglru_scan_bwd(a, h_all, dh_all, dh_final)
        else:
            da, db = rglru_scan_bwd(a, h_all, dh_all, dh_final)
            ops.lru_scan_bwd_launches += 1
        return (da if ctx.needs_input_grad[0] else None,
                db if ctx.needs_input_grad[1] else None)
