"""Mamba-1 selective scan on Hopper: the wrappers of ``csrc/mamba_scan.cu``
and ``csrc/mamba_scan_bwd.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.mamba_scan``.  The CUDA
kernel computes the same function from h = 0 (y in fp32, the final state in
fp32) for any L and DI and for ST up to 128, masking the ragged edges
itself, so nothing here pads.  ``b`` and ``c`` may be the strided slices of
the x_proj output as the Mamba layer makes them: the kernel takes their batch
and time strides.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.ref_mamba_scan`.

Training: ``mamba_scan(..., checkpoints=True)`` also writes the state after
every 8 steps (``ref.ckpt_shape``), and :func:`mamba_scan_bwd` wraps the
backward kernel, which recomputes each 8-step chunk from those checkpoints
and gives the gradients of all six inputs (no float atomics: partial sums
added in a fixed order).  The plain versions are
:func:`repro_torch.kernels.ref.ref_mamba_scan` (with the same checkpoints)
and :func:`repro_torch.kernels.ref.ref_mamba_scan_bwd`.
:class:`SelectiveScanFn` joins the forward and the backward for autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .flash_attention import DTYPE_CODES, on_card
from .ref import CKPT_STEPS, ckpt_shape, ref_mamba_scan, ref_mamba_scan_bwd

MAX_STATE = 128


def _entry(checkpoints: bool = False):
    lib = _build.load("mamba_scan")
    fn = lib.repro_mamba_scan_ckpt if checkpoints else lib.repro_mamba_scan
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * (9 if checkpoints else 8) + [i, i, i, i, q, q, q, q, i, p]
        fn.restype = i
    return fn


def _bwd_entries():
    lib = _build.load("mamba_scan_bwd")
    fn, ws = lib.repro_mamba_scan_bwd, lib.repro_mamba_scan_bwd_workspace
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        chunk = lib.repro_mamba_scan_bwd_chunk
        chunk.restype = i
        if chunk() != CKPT_STEPS:
            raise RuntimeError(f"mamba_scan_bwd: the kernel's chunk is {chunk()} steps, the "
                               f"checkpoints' {CKPT_STEPS}")
        fn.argtypes = [p] * 16 + [i, i, i, i, q, q, q, q, i, p]
        fn.restype = i
        ws.argtypes = [i, i, i, i]
        ws.restype = q
    return fn, ws


def _checked(name, xc, dt, a, b, c, d_skip):
    """The scan's inputs checked as both kernels take them -> (xc, dt, a, b,
    c, d_skip) with xc, dt, a and d_skip contiguous and b, c of unit state
    stride, and (B, L, DI, ST)."""
    ts = (xc, dt, a, b, c, d_skip)
    if not (on_card(xc) and all(t.device == xc.device for t in ts)):
        raise ValueError(f"{name}: every input must lie on one CUDA device")
    if xc.dtype not in DTYPE_CODES or b.dtype != xc.dtype or c.dtype != xc.dtype:
        raise ValueError(
            f"{name}: xc, b, c must share one of {list(DTYPE_CODES)}; "
            f"got {xc.dtype}, {b.dtype}, {c.dtype}"
        )
    if not all(t.dtype == torch.float32 for t in (dt, a, d_skip)):
        raise ValueError(f"{name}: dt, a and d_skip must be float32")
    if xc.dim() != 3 or a.dim() != 2 or b.dim() != 3 or d_skip.dim() != 1:
        raise ValueError(f"{name}: xc, dt (B,L,DI), a (DI,ST), b, c (B,L,ST), d_skip (DI,)")
    B, L, DI = xc.shape
    ST = a.shape[1]
    if (dt.shape != xc.shape or a.shape[0] != DI or b.shape != (B, L, ST)
            or c.shape != b.shape or d_skip.shape != (DI,)):
        raise ValueError(
            f"{name}: shapes xc {tuple(xc.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}, c {tuple(c.shape)}, d_skip {tuple(d_skip.shape)}"
        )
    if min(B, L, DI, ST) < 1 or B > 65535 or ST > MAX_STATE:
        raise ValueError(f"{name}: B={B}, L={L}, DI={DI}, ST={ST} out of range")
    xc, dt, a, d_skip = (t.contiguous() for t in (xc, dt, a, d_skip))
    b, c = (t if t.stride(2) == 1 else t.contiguous() for t in (b, c))
    return (xc, dt, a, b, c, d_skip), (B, L, DI, ST)


def mamba_scan(xc, dt, a, b, c, d_skip, checkpoints: bool = False):
    """xc, dt: (B, L, DI); a: (DI, ST); b, c: (B, L, ST); d_skip: (DI,), all on
    one CUDA device -> (y (B, L, DI) fp32, h_final (B, DI, ST) fp32), and with
    ``checkpoints`` the state after every 8 steps for :func:`mamba_scan_bwd`
    (``ref.ckpt_shape``, fp32), written by the same launch.

    xc, b and c share one dtype (fp32, fp16 or bf16); dt, a and d_skip are
    fp32.  Launches the CUDA kernel once, or raises: this function never
    computes on another path.
    """
    (xc, dt, a, b, c, d_skip), (B, L, DI, ST) = _checked("mamba_scan", xc, dt, a, b, c, d_skip)
    launch = _launch if xc.is_cuda else torch.ops.repro.mamba_scan
    return tuple(launch(xc, dt, a, b, c, d_skip, bool(checkpoints)))


def _scan_outputs(xc, a, checkpoints: bool) -> list[torch.Tensor]:
    B, L, DI = xc.shape
    ST = a.shape[1]
    shapes = [(B, L, DI), (B, DI, ST)] + ([ckpt_shape(B, L, DI, ST)] if checkpoints else [])
    return [torch.empty(s, dtype=torch.float32, device=xc.device) for s in shapes]


def _launch(xc: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, d_skip: torch.Tensor, checkpoints: bool) -> list[torch.Tensor]:
    """The forward kernel's launch on checked inputs (``_checked``'s) -> [y,
    h_final] and with ``checkpoints`` the checkpoints: the CUDA
    implementation of ``repro::mamba_scan``."""
    B, L, DI = xc.shape
    ST = a.shape[1]
    outs = _scan_outputs(xc, a, checkpoints)
    with torch.cuda.device(xc.device):
        err = _entry(checkpoints)(
            xc.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            d_skip.data_ptr(), *(t.data_ptr() for t in outs), B, L, DI, ST,
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            DTYPE_CODES[xc.dtype], torch.cuda.current_stream(xc.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"mamba_scan: CUDA error {err} at launch")
    return outs


_fwd_op = torch.library.custom_op("repro::mamba_scan", _launch, mutates_args=(),
                                  device_types="cuda")


@_fwd_op.register_fake
def _(xc, dt, a, b, c, d_skip, checkpoints):
    return _scan_outputs(xc, a, checkpoints)


def bwd_work_bytes(B: int, L: int, DI: int, ST: int) -> int:
    """Bytes of scratch the backward takes (``repro_mamba_scan_bwd_workspace``'s
    count, which the launch checks it against): fp32 partials of db and dc,
    one a group of channels (a 128-thread block holds 2 channels a thread
    over ``lpc`` lanes a channel, 4 states a lane), and of dA and dD, one a
    batch row, each 256-byte aligned."""
    lpc = 4 if ST <= 16 else 8 if ST <= 32 else 16 if ST <= 64 else 32
    groups = -(-DI // (128 // lpc * 2))

    def aligned(n: int) -> int:
        return (n + 255) // 256 * 256

    return (2 * aligned(groups * B * L * ST * 4) + aligned(B * DI * ST * 4)
            + aligned(B * DI * 4))


def mamba_scan_bwd(xc, dt, a, b, c, d_skip, dy, dh, ckpt):
    """The scan's gradient on the card: the forward's inputs, dy (B, L, DI)
    fp32, dh (B, DI, ST) fp32 or None (0) and the forward's checkpoints
    (``mamba_scan(..., checkpoints=True)``'s third output, contiguous and
    16-byte aligned) -> (dxc in xc's dtype, ddt fp32, da (DI, ST) fp32, db,
    dc (B, L, ST) contiguous in b's dtype, dd (DI,) fp32), the function of
    :func:`repro_torch.kernels.ref.ref_mamba_scan_bwd`.

    Launches the backward kernel and its fixed-order sum of partials on the
    current stream (scratch, :func:`bwd_work_bytes`, from PyTorch's
    allocator, taken here, where the dry run sees it), or raises: this
    function never computes on another path.
    """
    (xc, dt, a, b, c, d_skip), (B, L, DI, ST) = _checked(
        "mamba_scan_bwd", xc, dt, a, b, c, d_skip)
    if dy.device != xc.device or dy.dtype != torch.float32 or dy.shape != (B, L, DI):
        raise ValueError(f"mamba_scan_bwd: dy must be float32 ({B}, {L}, {DI}) on {xc.device}; "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if dh is not None and (dh.device != xc.device or dh.dtype != torch.float32
                           or dh.shape != (B, DI, ST)):
        raise ValueError(f"mamba_scan_bwd: dh must be float32 ({B}, {DI}, {ST}) on "
                         f"{xc.device}; got {dh.dtype} {tuple(dh.shape)} on {dh.device}")
    if (ckpt.device != xc.device or ckpt.dtype != torch.float32
            or ckpt.shape != ckpt_shape(B, L, DI, ST) or not ckpt.is_contiguous()
            or (ckpt.is_cuda and ckpt.data_ptr() % 16)):  # the kernel reads it with float4 loads
        raise ValueError(f"mamba_scan_bwd: ckpt must be contiguous, 16-byte aligned float32 "
                         f"{ckpt_shape(B, L, DI, ST)} on {xc.device}; got {ckpt.dtype} "
                         f"{tuple(ckpt.shape)} on {ckpt.device}")
    dy = dy.contiguous()
    dh = None if dh is None else dh.contiguous()
    work = torch.empty(bwd_work_bytes(B, L, DI, ST), dtype=torch.uint8, device=xc.device)
    launch = _launch_bwd if xc.is_cuda else torch.ops.repro.mamba_scan_bwd
    return tuple(launch(xc, dt, a, b, c, d_skip, dy, dh, ckpt, work))


def _launch_bwd(xc: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, d_skip: torch.Tensor, dy: torch.Tensor,
                dh: Optional[torch.Tensor], ckpt: torch.Tensor,
                work: torch.Tensor) -> list[torch.Tensor]:
    """The backward's launches on checked inputs -> [dxc, ddt, da, db, dc,
    dd], ``work`` their scratch: the CUDA implementation of
    ``repro::mamba_scan_bwd``.  Raises where ``work`` is not the size the
    library asks for."""
    B, L, DI = xc.shape
    ST = a.shape[1]
    dev = xc.device
    dxc = torch.empty_like(xc)
    ddt = torch.empty((B, L, DI), dtype=torch.float32, device=dev)
    da = torch.empty((DI, ST), dtype=torch.float32, device=dev)
    db = torch.empty((B, L, ST), dtype=b.dtype, device=dev)
    dc = torch.empty((B, L, ST), dtype=c.dtype, device=dev)
    dd = torch.empty((DI,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fn, ws = _bwd_entries()
        if ws(B, L, DI, ST) != work.numel():
            raise RuntimeError(f"mamba_scan_bwd: {ws(B, L, DI, ST)} bytes of scratch wanted, "
                               f"{work.numel()} given")
        err = fn(
            xc.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            d_skip.data_ptr(), dy.data_ptr(), 0 if dh is None else dh.data_ptr(),
            ckpt.data_ptr(), dxc.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
            dc.data_ptr(), dd.data_ptr(), work.data_ptr(), B, L, DI, ST,
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            DTYPE_CODES[xc.dtype], torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"mamba_scan_bwd: CUDA error {err} at launch")
    return [dxc, ddt, da, db, dc, dd]


_bwd_op = torch.library.custom_op("repro::mamba_scan_bwd", _launch_bwd, mutates_args=("work",),
                                  device_types="cuda")


@_bwd_op.register_fake
def _(xc, dt, a, b, c, d_skip, dy, dh, ckpt, work):
    B, L, DI = xc.shape
    ST = a.shape[1]
    dev = xc.device
    return [torch.empty_like(xc),
            torch.empty((B, L, DI), dtype=torch.float32, device=dev),
            torch.empty((DI, ST), dtype=torch.float32, device=dev),
            torch.empty((B, L, ST), dtype=b.dtype, device=dev),
            torch.empty((B, L, ST), dtype=c.dtype, device=dev),
            torch.empty((DI,), dtype=torch.float32, device=dev)]


class SelectiveScanFn(torch.autograd.Function):
    """The selective scan with a gradient.  ``apply(xc, dt, a, b, c, d_skip)``
    -> (y, h_final): on the card the forward launches :func:`mamba_scan` with
    checkpoints and the backward launches :func:`mamba_scan_bwd` once on them
    (counted in ``ops.selective_scan_bwd_launches``); on the CPU both are the
    plain versions.  Saves the inputs (b and c as the views they are: no
    copy) and the checkpoints, on the CPU too; under remat the forward, and
    so what it saves, is recomputed just before the backward.  An unused
    output's gradient arrives as None and counts as 0."""

    @staticmethod
    def forward(ctx, xc, dt, a, b, c, d_skip):
        ctx.set_materialize_grads(False)
        scan = ref_mamba_scan if xc.device.type == "cpu" else mamba_scan
        y, h, ckpt = scan(xc, dt, a, b, c, d_skip, checkpoints=True)
        ctx.save_for_backward(xc, dt, a, b, c, d_skip, ckpt)
        return y, h

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh):
        from . import ops  # the launch counter; ops imports this module

        xc, dt, a, b, c, d_skip, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(xc.shape, dtype=torch.float32, device=xc.device)
        if xc.device.type == "cpu":
            grads = ref_mamba_scan_bwd(xc, dt, a, b, c, d_skip, dy, dh)
        else:
            grads = mamba_scan_bwd(xc, dt, a, b, c, d_skip, dy, dh, ckpt)
            ops.selective_scan_bwd_launches += 1
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))
