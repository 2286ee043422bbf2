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
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HALF_DTYPES = (torch.float16, torch.bfloat16)
HEAD_DIMS = (64, 80, 128, 256)  # 80: hubert-xlarge, at a compute width of 128 on wgmma
TILINGS = ("wgmma", "fma")


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
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte-aligned start (vector and TMA loads)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention(q, k, v, causal: bool = True, window: int = 0, tiling: str | None = None):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) on one CUDA device -> (B, H, Sq, D).

    ``tiling`` defaults to :func:`attention_tiling`'s choice; a tiling that
    does not take the dtype raises.  Launches the CUDA kernel once, or
    raises: this function never computes on another path.
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
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _entry(tiling)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
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
