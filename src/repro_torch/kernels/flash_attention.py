"""Flash attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention``.  The CUDA
kernels compute the same function (GQA; causal, sliding-window or full; fp32
online softmax; output in q's dtype) and mask ragged sequence tails
themselves, so nothing here pads.  Two tilings, one C entry point each:
``wgmma`` (tensor cores, TMA loads; bf16/fp16 at a head dim that is a
multiple of 8, TMA's 16-byte rows) and ``fma`` (fp32 FMAs on the CUDA cores;
any dtype and any head dim), at every head dim from 1 to
:data:`MAX_HEAD_DIM` (the JAX kernel blocks only the sequence and takes any)
and at any Sq and Sk (cross-attention: Sq the prompt, Sk the image tokens).
A kernel computes at a width (:func:`compute_width`) of its own at or above
the head dim; columns past the head dim are zeros in every product and are
not stored.  :func:`attention_tiling` chooses.  Their plain PyTorch
version is :func:`repro_torch.kernels.ref.ref_flash_attention`.

A query row that sees no key (a window with ``Sq >= Sk + window``; see
:func:`first_masked_row`) gets what the plain version and the JAX oracle
give it: their softmax over a row of equal masked scores is uniform, so the
row is the mean of v over all Sk keys.  The kernels skip key tiles that are
wholly masked, so they leave such rows at 0 or at a mean over the tiles they
did not skip; the wrapper writes those rows itself after the launch.  The
shapes alone mark them, so this is deterministic, touches no row that sees
a key, and does nothing at Sq = Sk (every served prefill).

Training: given ``lse``, either tiling also writes each query row's
log-sum-exp, and :func:`flash_attention_bwd` (``csrc/flash_attention_bwd.cu``,
the forward's head dims at the forward's widths; width 80 on ``wgmma`` at its
true width, S and dP computed once and dq summed in fp32 scratch in a fixed
order) computes dq, dk and dv from it on one of two tilings, ``wgmma``
(bf16/fp16) and ``fma`` (any dtype; exact fp32), one C entry point each;
:func:`attention_bwd_tiling` chooses.  :class:`FlashAttentionFn` joins
the forward and the backward for autograd.  The backward refuses shapes with rows that see no key: the mean-of-v rows
have a gradient the kernel does not compute, and no training shape (Sq = Sk)
has them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._build import sm_count

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HALF_DTYPES = (torch.float16, torch.bfloat16)
TILINGS = ("wgmma", "fma")
MAX_HEAD_DIM = 256  # the largest head dim the kernels take (recurrentgemma-9b's)
# The widths the kernels compute at, forward and backward.  wgmma: 64 (head
# dims 8-64, the smoke configs' 16 among them), 80 (hubert-xlarge's 80, and
# 72: its own kernels, products at the true width), 128 (granite-8b/34b,
# deepseek-coder-33b, the VLM) and 256 (recurrentgemma-9b).  fma: 32 (the fp32
# model of examples/train_lm_topoopt.py), 64 (minicpm-2b), 80, 128 and 256 each
# have instances of their own; any other head dim runs a ragged instance at
# the next of FMA_RAGGED_WIDTHS, whose loads and stores are masked to it.
WGMMA_WIDTHS = (64, 80, 128, 256)
FMA_WIDTHS = (32, 64, 80, 128, 256)
FMA_RAGGED_WIDTHS = (32, 64, 128, 256)
MODELLED_SMS = 132  # the H100 SXM5's SMs, which size launches on the dry run's card


def compute_width(tiling: str, head_dim: int) -> int:
    """The width that ``tiling``'s kernels compute ``head_dim`` at: the head
    dim itself where it has instances of its own, else the next width above
    (``csrc/flash_attention.cu``'s and ``flash_attention_bwd.cu``'s dispatch)."""
    if tiling == "fma" and head_dim in FMA_WIDTHS:
        return head_dim
    widths = WGMMA_WIDTHS if tiling == "wgmma" else FMA_RAGGED_WIDTHS
    return next(w for w in widths if w >= head_dim)


def _tiling(name: str, dtype: torch.dtype, head_dim: int, tiling: str | None) -> str:
    """``tiling``, else ``"wgmma"`` for bf16/fp16 at a head dim that is a
    multiple of 8 and ``"fma"`` for the rest; raises for a dtype or a head
    dim that tiling does not take, and for a head dim past
    :data:`MAX_HEAD_DIM`."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not in {list(DTYPE_CODES)}")
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {head_dim} outside 1..{MAX_HEAD_DIM}: the kernels "
                         f"take head dims up to MAX_HEAD_DIM = {MAX_HEAD_DIM}")
    tiling = tiling or ("wgmma" if dtype in HALF_DTYPES and head_dim % 8 == 0 else "fma")
    if tiling not in TILINGS or (tiling == "wgmma" and dtype not in HALF_DTYPES):
        raise ValueError(f"{name}: tiling {tiling!r} does not take {dtype}")
    if tiling == "wgmma" and head_dim % 8:
        raise ValueError(f"{name}: head dim {head_dim} is not a multiple of 8, which the wgmma "
                         "tiling's TMA loads need (16-byte rows)")
    return tiling


def attention_tiling(dtype: torch.dtype, head_dim: int) -> str:
    """The tiling that serves q, k, v of this dtype and head dim: ``"wgmma"``
    for bf16/fp16 at a head dim that is a multiple of 8, ``"fma"`` for fp32
    and for bf16/fp16 rows TMA cannot stride.  Raises past
    :data:`MAX_HEAD_DIM`."""
    return _tiling("flash_attention", dtype, head_dim, None)


def first_masked_row(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The first query row that sees no key; ``Sq`` if every row sees one.

    Query and key positions both count from 0.  A row q sees keys k < Sk
    with ``k <= q`` (causal) and ``k > q - window`` (window > 0).  Without a
    window every row sees key 0.  With one, the oldest key row q may see is
    ``q - window + 1``, causal or not, so exactly the rows
    ``q >= Sk + window - 1`` see none.
    """
    return Sq if window <= 0 else min(Sq, Sk + window - 1)


def _entry(tiling: str):
    fn = getattr(_build.load("flash_attention"), f"repro_flash_attention_{tiling}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def attention_bwd_tiling(dtype: torch.dtype, head_dim: int) -> str:
    """The backward tiling for this dtype and head dim: the forward's,
    ``"wgmma"`` for bf16/fp16 at a head dim that is a multiple of 8, ``"fma"``
    for the rest (for fp32, exact fp32 products, which TF32 would not give).
    Raises past :data:`MAX_HEAD_DIM`."""
    return _tiling("flash_attention_bwd", dtype, head_dim, None)


def _bwd_entries(tiling: str):
    lib = _build.load("flash_attention_bwd")
    fn = getattr(lib, f"repro_flash_attention_bwd_{tiling}")
    ws = lib.repro_flash_attention_bwd_workspace
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 10 + [p]
        fn.restype = i
    if ws.argtypes is None:
        ws.argtypes = [ctypes.c_int] * 7
        ws.restype = ctypes.c_longlong
    return fn, ws


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card: a CUDA tensor, or a ``meta`` one, which
    stands for the card in the dry run (``launch.dryrun``).  A wrapper calls
    its kernel's launch directly on a CUDA tensor and its ``torch.library``
    op on a meta one, whose fake implementation gives the outputs and
    computes nothing."""
    return t.is_cuda or t.is_meta


def sms_of(device: torch.device) -> int:
    """The SMs that size a launch on ``device``: the card's own, or
    :data:`MODELLED_SMS` on the dry run's ``meta`` card."""
    return sm_count(device.index) if device.type == "cuda" else MODELLED_SMS


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte-aligned start on the card (vector and TMA
    loads)."""
    t = t.contiguous()
    return t.clone() if t.is_cuda and t.data_ptr() % 16 else t


def flash_attention(q, k, v, causal: bool = True, window: int = 0, tiling: str | None = None,
                    lse=None):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) on one CUDA device -> (B, H, Sq, D).

    ``tiling`` defaults to :func:`attention_tiling`'s choice; a tiling that
    does not take the dtype raises.  ``lse``: None, or a contiguous
    (B, H, Sq) fp32 tensor on the same device that gets each row's
    log-sum-exp (natural log).  Launches the CUDA kernel once, or raises:
    this function never computes on another path.
    """
    if not (on_card(q) and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must lie on one CUDA device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v must share one of {list(DTYPE_CODES)}; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q (B,H,Sq,D), k and v (B,KV,Sk,D)")
    B, H, Sq, D = q.shape
    _, KV, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    tiling = _tiling("flash_attention", q.dtype, D, tiling)
    if min(B, H, Sq, Sk) < 1 or window < 0:
        raise ValueError("flash_attention: empty input or negative window")
    if lse is not None and not (
        lse.device == q.device and lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
        and lse.is_contiguous()
    ):
        raise ValueError(f"flash_attention: lse must be a contiguous ({B}, {H}, {Sq}) fp32 "
                         "tensor on q's device")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    launch = _launch if q.is_cuda else torch.ops.repro.flash_attention
    out = launch(q, k, v, lse, bool(causal), int(window), tiling)
    first = first_masked_row(Sq, Sk, causal, window)
    if first < Sq:  # rows that see no key: the mean of v over all Sk keys
        v_mean = v.float().mean(dim=2).repeat_interleave(H // KV, dim=1)  # (B, H, D)
        out[:, :, first:] = v_mean[:, :, None].to(out.dtype)
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: Optional[torch.Tensor],
            causal: bool, window: int, tiling: str) -> torch.Tensor:
    """The forward kernel's launch on checked, aligned inputs: the CUDA
    implementation of ``repro::flash_attention``."""
    B, H, Sq, D = q.shape
    _, KV, Sk, _ = k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _entry(tiling)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, KV, Sq, Sk, D, int(causal), window,
            DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention ({tiling}): CUDA error {err} at launch")
    return out


_fwd_op = torch.library.custom_op("repro::flash_attention", _launch, mutates_args=("lse",),
                                  device_types="cuda")


@_fwd_op.register_fake
def _(q, k, v, lse, causal, window, tiling):
    return torch.empty_like(q)


def check_bwd(q, k, causal: bool, window: int) -> None:
    """Raises ``ValueError`` for what the backward kernel does not take: a head
    dim that :func:`attention_bwd_tiling`'s tiling does not take, or rows
    that see no key."""
    attention_bwd_tiling(q.dtype, q.shape[3])
    _check_rows(q, k, causal, window)


def _check_rows(q, k, causal: bool, window: int) -> None:
    Sq = q.shape[2]
    first = first_masked_row(Sq, k.shape[2], causal, window)
    if first < Sq:
        raise ValueError(f"flash_attention_bwd: rows {first}..{Sq - 1} see no key "
                         f"(Sq {Sq}, Sk {k.shape[2]}, window {window}); their mean-of-v "
                         "output has a gradient the kernel does not compute")


def bwd_work_bytes(B: int, H: int, KV: int, Sq: int, Sk: int, D: int, sms: int) -> int:
    """Bytes of scratch the wgmma backward takes (the fma tiling takes none):
    ``repro_flash_attention_bwd_workspace``'s count, which the launch checks
    it against.  At width 80 (D 72 and 80) a turn counter a 64-row query tile
    (256-byte aligned) and dq's fp32 sums, (B*H, ceil(Sq / 64)*64, 80); at
    width 256 (D 136-256), where the key blocks (64 keys each) of all kv heads
    are fewer than the SMs, the query heads of a kv head split over the spare
    SMs and each split writes fp32 partials of dk and dv, (B, KV, Sk, D) each;
    else none."""
    width = compute_width("wgmma", D)
    if width == 80:
        tiles = B * H * -(-Sq // 64)
        return (tiles * 4 + 255) // 256 * 256 + tiles * 64 * 80 * 4
    g = H // KV
    blocks = -(-Sk // 64) * KV * B
    if width != 256 or blocks >= sms:
        return 0
    per = -(-g // min(g, sms // blocks))
    splits = -(-g // per)
    return 2 * splits * B * KV * Sk * D * 4 if splits > 1 else 0


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True, window: int = 0,
                        tiling: str | None = None):
    """The gradient of :func:`flash_attention` -> (dq, dk, dv) in q's dtype.

    q, o, do: (B, H, Sq, D); k, v: (B, KV, Sk, D); lse: (B, H, Sq) fp32 from
    the forward, all on one CUDA device; D from 1 to :data:`MAX_HEAD_DIM`.
    ``tiling`` defaults to :func:`attention_bwd_tiling`'s
    choice; a tiling that does not take the dtype or the head dim raises.
    Launches the CUDA backward once (three kernels on the current stream; at
    width 256 the wgmma tiling may split the query heads of a kv head into
    fp32 partials, from PyTorch's allocator, that a fourth kernel adds in a
    fixed order; at width 80 it sums dq in fp32 scratch from
    PyTorch's allocator, its turn counters zeroed on every call, and a last
    kernel casts it), or raises:
    it never computes on another path.  The scratch (``delta`` and
    :func:`bwd_work_bytes`) is taken here, where the dry run sees it.
    """
    ts = (q, k, v, o, lse, do)
    if not all(on_card(t) and t.device == q.device for t in ts):
        raise ValueError("flash_attention_bwd: every input must lie on one CUDA device")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise ValueError(f"flash_attention_bwd: q, k, v, o, do must share one of "
                         f"{list(DTYPE_CODES)}; got {[t.dtype for t in (q, k, v, o, do)]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or o.shape != q.shape \
            or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: q, o, do (B,H,Sq,D); k and v (B,KV,Sk,D)")
    B, H, Sq, D = q.shape
    _, KV, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV or min(B, H, Sq, Sk) < 1:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: lse must be ({B}, {H}, {Sq}) fp32")
    if window < 0:
        raise ValueError("flash_attention_bwd: negative window")
    tiling = _tiling("flash_attention_bwd", q.dtype, D, tiling)
    _check_rows(q, k, causal, window)
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    sms = sms_of(q.device)
    nbytes = bwd_work_bytes(B, H, KV, Sq, Sk, D, sms) if tiling == "wgmma" else 0
    work = torch.empty(nbytes // 4, dtype=torch.float32, device=q.device) if nbytes else None
    launch = _launch_bwd if q.is_cuda else torch.ops.repro.flash_attention_bwd
    dq, dk, dv = launch(q, k, v, o, lse, do, delta, work, bool(causal), int(window), sms,
                        tiling)
    return dq, dk, dv


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                lse: torch.Tensor, do: torch.Tensor, delta: torch.Tensor,
                work: Optional[torch.Tensor], causal: bool, window: int, sms: int,
                tiling: str) -> list[torch.Tensor]:
    """The backward kernels' launch on checked, aligned inputs -> [dq, dk,
    dv], ``delta`` and ``work`` their scratch: the CUDA implementation of
    ``repro::flash_attention_bwd``.  Raises where ``work`` is not the size
    the library asks for."""
    B, H, Sq, D = q.shape
    _, KV, Sk, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        fn, ws = _bwd_entries(tiling)
        nbytes = ws(B, H, KV, Sq, Sk, D, sms) if tiling == "wgmma" else 0
        if nbytes != (0 if work is None else work.numel() * 4):
            raise RuntimeError(f"flash_attention_bwd: {nbytes} bytes of scratch wanted, "
                               f"{0 if work is None else work.numel() * 4} given")
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            None if work is None else work.data_ptr(),
            B, H, KV, Sq, Sk, D, int(causal), window, sms, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention_bwd ({tiling}): CUDA error {err} at launch")
    return [dq, dk, dv]


_bwd_op = torch.library.custom_op("repro::flash_attention_bwd", _launch_bwd,
                                  mutates_args=("delta", "work"), device_types="cuda")


@_bwd_op.register_fake
def _(q, k, v, o, lse, do, delta, work, causal, window, sms, tiling):
    return [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the forward launches the kernel with
    ``lse`` and saves what it launched on (``_aligned`` may copy) with the
    output and ``lse``; the backward launches :func:`flash_attention_bwd` on
    :func:`attention_bwd_tiling`'s choice.  ``apply(q, k, v, causal, window,
    tiling)``, ``tiling`` the forward's."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, tiling):
        check_bwd(q, k, causal, window)
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        o = flash_attention(q, k, v, causal=causal, window=window, tiling=tiling, lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        from . import ops  # the launch counters; ops imports this module

        q, k, v, o, lse = ctx.saved_tensors
        tiling = attention_bwd_tiling(q.dtype, q.shape[-1])
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal, ctx.window, tiling)
        ops.attention_bwd_launches += 1
        if tiling == "wgmma":
            ops.attention_bwd_wgmma_launches += 1
        else:
            ops.attention_bwd_fma_launches += 1
        return dq, dk, dv, None, None, None
