"""Flash attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention``.  The CUDA
kernels compute the same function (GQA; causal, sliding-window or full; fp32
online softmax; output in q's dtype) and mask ragged sequence tails
themselves, so nothing here pads.  Two tilings, one C entry point each:
``wgmma`` (tensor cores, TMA loads; bf16/fp16) and ``fma`` (fp32 FMAs on the
CUDA cores; fp32), each at head dims 64, 80, 128 and 256, and at any Sq and
Sk (cross-attention: Sq the prompt, Sk the image tokens).
:func:`attention_tiling` chooses.  Their plain PyTorch
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
head dims 64, 80, 128 and 256; 80 at its true width on ``wgmma``, as the
forward, S and dP computed once and dq summed in fp32 scratch in a fixed
order) computes dq, dk and dv from it on one of two tilings, ``wgmma``
(bf16/fp16) and ``fma`` (any dtype; exact fp32), one C entry point each;
:func:`attention_bwd_tiling` chooses.  :class:`FlashAttentionFn` joins
the forward and the backward for autograd.  The backward refuses
shapes with rows that see no key: the mean-of-v rows have a gradient the
kernel does not compute, and no training shape (Sq = Sk) has them.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._build import sm_count

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HALF_DTYPES = (torch.float16, torch.bfloat16)
HEAD_DIMS = (64, 80, 128, 256)  # 80: hubert-xlarge, its own wgmma kernels at the true width
TILINGS = ("wgmma", "fma")
# minicpm-2b; hubert-xlarge; granite-8b/34b, deepseek-coder-33b, the VLM; recurrentgemma
BWD_HEAD_DIMS = (64, 80, 128, 256)


def attention_tiling(dtype: torch.dtype, head_dim: int) -> str:
    """The tiling that serves q, k, v of this dtype and head dim: ``"wgmma"``
    for bf16/fp16, ``"fma"`` for fp32."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {head_dim} not in {HEAD_DIMS}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {dtype} not in {list(DTYPE_CODES)}")
    return "wgmma" if dtype in HALF_DTYPES else "fma"


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
    """The backward tiling for this dtype and head dim: ``"wgmma"`` for
    bf16/fp16, ``"fma"`` for fp32 (exact fp32 products, which TF32 would not
    give)."""
    if head_dim not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {head_dim} not in {BWD_HEAD_DIMS}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention_bwd: dtype {dtype} not in {list(DTYPE_CODES)}")
    return "wgmma" if dtype in HALF_DTYPES else "fma"


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte-aligned start (vector and TMA loads)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention(q, k, v, causal: bool = True, window: int = 0, tiling: str | None = None,
                    lse=None):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) on one CUDA device -> (B, H, Sq, D).

    ``tiling`` defaults to :func:`attention_tiling`'s choice; a tiling that
    does not take the dtype raises.  ``lse``: None, or a contiguous
    (B, H, Sq) fp32 tensor on the same device that gets each row's
    log-sum-exp (natural log).  Launches the CUDA kernel once, or raises:
    this function never computes on another path.
    """
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
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
    chosen = attention_tiling(q.dtype, D)  # also refuses a head dim no tiling takes
    tiling = tiling or chosen
    if tiling not in TILINGS or (tiling == "wgmma" and q.dtype not in HALF_DTYPES):
        raise ValueError(f"flash_attention: tiling {tiling!r} does not take {q.dtype}")
    if min(B, H, Sq, Sk) < 1 or window < 0:
        raise ValueError("flash_attention: empty input or negative window")
    if lse is not None and not (
        lse.device == q.device and lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
        and lse.is_contiguous()
    ):
        raise ValueError(f"flash_attention: lse must be a contiguous ({B}, {H}, {Sq}) fp32 "
                         "tensor on q's device")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _entry(tiling)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, KV, Sq, Sk, D, int(bool(causal)), int(window),
            DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention ({tiling}): CUDA error {err} at launch")
    first = first_masked_row(Sq, Sk, causal, window)
    if first < Sq:  # rows that see no key: the mean of v over all Sk keys
        v_mean = v.float().mean(dim=2).repeat_interleave(H // KV, dim=1)  # (B, H, D)
        out[:, :, first:] = v_mean[:, :, None].to(out.dtype)
    return out


def check_bwd(q, k, causal: bool, window: int) -> None:
    """Raises ``ValueError`` for what the backward kernel does not take: a head
    dim outside ``BWD_HEAD_DIMS``, or rows that see no key."""
    Sq, D = q.shape[2], q.shape[3]
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {D} not in {BWD_HEAD_DIMS}")
    first = first_masked_row(Sq, k.shape[2], causal, window)
    if first < Sq:
        raise ValueError(f"flash_attention_bwd: rows {first}..{Sq - 1} see no key "
                         f"(Sq {Sq}, Sk {k.shape[2]}, window {window}); their mean-of-v "
                         "output has a gradient the kernel does not compute")


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True, window: int = 0,
                        tiling: str | None = None):
    """The gradient of :func:`flash_attention` -> (dq, dk, dv) in q's dtype.

    q, o, do: (B, H, Sq, D); k, v: (B, KV, Sk, D); lse: (B, H, Sq) fp32 from
    the forward, all on one CUDA device; D 64, 80, 128 or 256.  ``tiling``
    defaults to :func:`attention_bwd_tiling`'s choice; a tiling that does not
    take the dtype raises.  Launches the CUDA backward once (three kernels on
    the current stream; at D = 256 the wgmma tiling may split the query heads
    of a kv head into fp32 partials, from PyTorch's allocator, that a fourth
    kernel adds in a fixed order; at D = 80 it sums dq in fp32 scratch from
    PyTorch's allocator, its turn counters zeroed on every call, and a last
    kernel casts it), or raises:
    it never computes on another path.
    """
    ts = (q, k, v, o, lse, do)
    if not all(t.is_cuda and t.device == q.device for t in ts):
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
    check_bwd(q, k, causal, window)
    tiling = tiling or attention_bwd_tiling(q.dtype, D)
    if tiling not in TILINGS or (tiling == "wgmma" and q.dtype not in HALF_DTYPES):
        raise ValueError(f"flash_attention_bwd: tiling {tiling!r} does not take {q.dtype}")
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        fn, ws = _bwd_entries(tiling)
        sms = sm_count(q.device.index)
        nbytes = ws(B, H, KV, Sq, Sk, D, sms) if tiling == "wgmma" else 0
        work = torch.empty(nbytes // 4, dtype=torch.float32, device=q.device) if nbytes else None
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            None if work is None else work.data_ptr(),
            B, H, KV, Sq, Sk, D, int(bool(causal)), int(window), sms, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention_bwd ({tiling}): CUDA error {err} at launch")
    return dq, dk, dv


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
