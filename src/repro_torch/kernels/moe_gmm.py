"""Grouped (per-expert) matmul on Hopper: the wrapper of ``csrc/moe_gmm.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.moe_gmm``.  The CUDA kernels
compute the same function (``out[e] = x[e] @ w[e]``, fp32 accumulation,
output in x's dtype) and mask the ragged edges of C, D and F themselves, so
nothing here pads.  Three tilings, one C entry point each: ``wgmma``
(tensor cores, TMA loads; prefill in bf16/fp16), ``fma`` (fp32 FMAs on the
CUDA cores) and ``skinny`` (a weight stream for decode's few rows, which
skips experts whose rows of x are all zero).  :func:`gmm_tiling` chooses.
Their plain PyTorch version is :func:`repro_torch.kernels.ref.ref_moe_gmm`.

Training: :func:`moe_gmm_bwd` wraps ``csrc/moe_gmm_bwd.cu``, which computes
``dx[e] = dy[e] @ w[e]^T`` and ``dw[e] = x[e]^T @ dy[e]`` on two tilings,
``wgmma`` (bf16/fp16; every operand read in place through wgmma's transpose
bits; persistent blocks, one an SM, in pairs at adjacent tiles) and
``fma`` (fp32 FMAs on the CUDA cores), one C entry point each;
:func:`gmm_bwd_tiling` chooses.  Its plain version is
:func:`repro_torch.kernels.ref.ref_moe_gmm_bwd`.  :class:`GroupedMatmulFn`
joins the forward and the backward for autograd.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._build import sm_count
from .flash_attention import DTYPE_CODES, HALF_DTYPES, _aligned, on_card
from .ref import ref_moe_gmm, ref_moe_gmm_bwd

SKINNY_MAX_C = 16  # rows of x up to which the weight stream beats a tiled product
SKINNY_MAX_D = 32768  # x's rows are staged in shared memory as fp32 beside the ring
TILINGS = ("wgmma", "fma", "skinny")
BWD_TILINGS = ("wgmma", "fma")


def gmm_tiling(dtype: torch.dtype, C: int, D: int, F: int) -> str:
    """The tiling that serves (E, C, D) @ (E, D, F) in this dtype: ``"skinny"``
    for C <= 16 and D <= 32768, ``"wgmma"`` for C > 16 in bf16/fp16 with D and
    F multiples of 8 (TMA's 16-byte row strides), ``"fma"`` otherwise."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"moe_gmm: dtype {dtype} not in {list(DTYPE_CODES)}")
    if C <= SKINNY_MAX_C:
        return "skinny" if D <= SKINNY_MAX_D else "fma"
    if dtype in HALF_DTYPES and D % 8 == 0 and F % 8 == 0:
        return "wgmma"
    return "fma"


def _takes(tiling: str, dtype: torch.dtype, C: int, D: int, F: int) -> bool:
    if tiling == "wgmma":
        return gmm_tiling(dtype, C, D, F) == "wgmma"
    if tiling == "skinny":
        return C <= SKINNY_MAX_C and D <= SKINNY_MAX_D
    return tiling == "fma"


def gmm_bwd_tiling(dtype: torch.dtype, C: int, D: int, F: int) -> str:
    """The tiling of the backward of (E, C, D) @ (E, D, F) in this dtype:
    ``"wgmma"`` for bf16/fp16 with D and F multiples of 8 (TMA's 16-byte row
    strides; any C), ``"fma"`` otherwise."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"moe_gmm_bwd: dtype {dtype} not in {list(DTYPE_CODES)}")
    return "wgmma" if dtype in HALF_DTYPES and D % 8 == 0 and F % 8 == 0 else "fma"


def _entry(tiling: str):
    fn = getattr(_build.load("moe_gmm"), f"repro_moe_gmm_{tiling}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = i
    return fn


def _bwd_entry(tiling: str):
    fn = getattr(_build.load("moe_gmm_bwd"), f"repro_moe_gmm_bwd_{tiling}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        sms = [i] if tiling == "wgmma" else []  # the SMs that size the persistent launch
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, *sms, p]
        fn.restype = i
    return fn


def moe_gmm(x, w, tiling: str | None = None):
    """x: (E, C, D); w: (E, D, F) on one CUDA device -> (E, C, F) in x's dtype.

    ``tiling`` defaults to :func:`gmm_tiling`'s choice; a tiling that does
    not take the shape or dtype raises.  Launches the CUDA kernel once, or
    raises: this function never computes on another path.

    The ``skinny`` tiling writes zeros for a block of rows of x (R = 1 at
    C = 1, else 4 rows) that are all exactly zero, without reading the
    expert's weights: the MoE layer leaves every expert that no token was
    routed to with such rows.  For finite weights that is the same function
    (0 * w = 0); where w holds an inf or a NaN, the plain version gives NaN
    in those rows and the kernel 0.
    """
    if not (on_card(x) and w.device == x.device):
        raise ValueError("moe_gmm: x and w must lie on one CUDA device")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(
            f"moe_gmm: x and w must share one of {list(DTYPE_CODES)}; got {x.dtype}, {w.dtype}"
        )
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm: x (E,C,D) and w (E,D,F); got {tuple(x.shape)}, {tuple(w.shape)}")
    E, C, D = x.shape
    F = w.shape[2]
    if min(E, C, D, F) < 1:
        raise ValueError("moe_gmm: empty input")
    if E > 65535 or C > 65535 * 64 or F > 65535 * 128 or D >= 2**31:
        raise ValueError(f"moe_gmm: grid too large: x {tuple(x.shape)}, w {tuple(w.shape)}")
    tiling = tiling or gmm_tiling(x.dtype, C, D, F)
    if tiling not in TILINGS or not _takes(tiling, x.dtype, C, D, F):
        raise ValueError(f"moe_gmm: tiling {tiling!r} does not take {x.dtype} at C={C} D={D} F={F}")
    x, w = _aligned(x), _aligned(w)
    return (_launch if x.is_cuda else torch.ops.repro.moe_gmm)(x, w, tiling)


def _launch(x: torch.Tensor, w: torch.Tensor, tiling: str) -> torch.Tensor:
    """The forward kernel's launch on checked, aligned inputs: the CUDA
    implementation of ``repro::moe_gmm``."""
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry(tiling)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
            DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"moe_gmm ({tiling}): CUDA error {err} at launch")
    return out


_fwd_op = torch.library.custom_op("repro::moe_gmm", _launch, mutates_args=(),
                                  device_types="cuda")


@_fwd_op.register_fake
def _(x, w, tiling):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


def moe_gmm_bwd(x, w, dy, need_dx: bool = True, need_dw: bool = True,
                tiling: str | None = None):
    """The gradient of :func:`moe_gmm` -> (dx (E, C, D) in x's dtype or None,
    dw (E, D, F) in w's dtype or None): ``dx[e] = dy[e] @ w[e]^T`` and
    ``dw[e] = x[e]^T @ dy[e]``, fp32 sums, for what ``need_dx`` and
    ``need_dw`` ask.

    x: (E, C, D), w: (E, D, F), dy: (E, C, F), one dtype, on one CUDA device.
    ``tiling`` defaults to :func:`gmm_bwd_tiling`'s choice; a tiling that
    does not take the shape or dtype raises.  Launches the CUDA backward once
    (a kernel for each output asked for, on the current stream), or raises:
    it never computes on another path.  The ``wgmma`` tiling's launch is
    sized by the device's SMs.
    """
    if not all(on_card(t) and t.device == x.device for t in (x, w, dy)):
        raise ValueError("moe_gmm_bwd: x, w and dy must lie on one CUDA device")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype or dy.dtype != x.dtype:
        raise ValueError(f"moe_gmm_bwd: x, w and dy must share one of {list(DTYPE_CODES)}; "
                         f"got {x.dtype}, {w.dtype}, {dy.dtype}")
    if x.dim() != 3 or w.dim() != 3 or dy.dim() != 3:
        raise ValueError("moe_gmm_bwd: x (E,C,D), w (E,D,F) and dy (E,C,F)")
    E, C, D = x.shape
    F = w.shape[2]
    if tuple(w.shape) != (E, D, F) or tuple(dy.shape) != (E, C, F):
        raise ValueError(f"moe_gmm_bwd: x (E,C,D), w (E,D,F) and dy (E,C,F); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(dy.shape)}")
    if min(E, C, D, F) < 1:
        raise ValueError("moe_gmm_bwd: empty input")
    if E > 65535 or C > 65535 * 64 or D > 65535 * 64 or F > 65535 * 256:
        raise ValueError(f"moe_gmm_bwd: grid too large: x {tuple(x.shape)}, w {tuple(w.shape)}")
    tiling = tiling or gmm_bwd_tiling(x.dtype, C, D, F)
    if tiling not in BWD_TILINGS or (tiling == "wgmma"
                                     and gmm_bwd_tiling(x.dtype, C, D, F) != "wgmma"):
        raise ValueError(f"moe_gmm_bwd: tiling {tiling!r} does not take {x.dtype} at C={C} "
                         f"D={D} F={F}")
    x, w, dy = _aligned(x), _aligned(w), _aligned(dy)
    launch = _launch_bwd if x.is_cuda else torch.ops.repro.moe_gmm_bwd
    grads = iter(launch(x, w, dy, bool(need_dx), bool(need_dw), tiling))
    dx = next(grads) if need_dx else None
    dw = next(grads) if need_dw else None
    return dx, dw


def _launch_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, need_dx: bool,
                need_dw: bool, tiling: str) -> list[torch.Tensor]:
    """The backward kernels' launch on checked, aligned inputs -> [dx, dw],
    each only where asked for: the CUDA implementation of
    ``repro::moe_gmm_bwd``."""
    sms = [sm_count(x.device.index)] if tiling == "wgmma" else []
    E, C, D = x.shape
    F = w.shape[2]
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    with torch.cuda.device(x.device):
        err = _bwd_entry(tiling)(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(), 0 if dx is None else dx.data_ptr(),
            0 if dw is None else dw.data_ptr(), E, C, D, F, int(need_dx), int(need_dw),
            DTYPE_CODES[x.dtype], *sms, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"moe_gmm_bwd ({tiling}): CUDA error {err} at launch")
    return [g for g in (dx, dw) if g is not None]


_bwd_op = torch.library.custom_op("repro::moe_gmm_bwd", _launch_bwd, mutates_args=(),
                                  device_types="cuda")


@_bwd_op.register_fake
def _(x, w, dy, need_dx, need_dw, tiling):
    return [torch.empty_like(t) for t, need in ((x, need_dx), (w, need_dw)) if need]


class GroupedMatmulFn(torch.autograd.Function):
    """The grouped matmul with a gradient.  ``apply(x, w)``: on the card the
    forward launches :func:`moe_gmm` on :func:`gmm_tiling`'s choice and the
    backward launches :func:`moe_gmm_bwd` once on :func:`gmm_bwd_tiling`'s
    choice, for the inputs that need a gradient (counted in
    ``ops.grouped_matmul_bwd_launches`` and, by tiling,
    ``ops.grouped_matmul_bwd_wgmma_launches`` or
    ``ops.grouped_matmul_bwd_fma_launches``); on the CPU both are the plain
    versions.  Saves x and w (w is the parameter itself: no copy); under
    remat the forward, and so what it saves, is recomputed."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return ref_moe_gmm(x, w)
        return moe_gmm(x, w, tiling=gmm_tiling(x.dtype, x.shape[1], x.shape[2], w.shape[2]))

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        from . import ops  # the launch counters; ops imports this module

        x, w = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad
        if dy.device.type == "cpu":
            dx, dw = ref_moe_gmm_bwd(x, w, dy)
            return (dx if need_dx else None), (dw if need_dw else None)
        tiling = gmm_bwd_tiling(x.dtype, x.shape[1], x.shape[2], w.shape[2])
        dx, dw = moe_gmm_bwd(x, w, dy, need_dx, need_dw, tiling)
        ops.grouped_matmul_bwd_launches += 1
        if tiling == "wgmma":
            ops.grouped_matmul_bwd_wgmma_launches += 1
        else:
            ops.grouped_matmul_bwd_fma_launches += 1
        return dx, dw
