"""The RG-LRU kernels' order of carries, against the JAX package, on the CPU.

``csrc/rglru_scan.cu`` and ``csrc/rglru_scan_bwd.cu`` cut time into chunks
of CH steps (WARPS chunks a round, one a warp): each chunk is walked from a
zero carry (its end value u and the product A of its decays), the carries
across chunks are composed in one fixed order (x = fmaf(A, x, u), chunk
after chunk, the backward from the last), and each chunk is walked again
from its carry-in.  The plain torch model here computes exactly that, with
CH and WARPS read from the sources, and is held to the JAX package's Pallas
``rglru_scan`` in interpret mode and its ``ref.ref_rglru_scan`` (forward,
the bars of ``test_torch_scan.py``) and to ``jax.vjp`` of
``ref.ref_rglru_scan`` (backward, 1e-4 of the largest gradient, as
``test_torch_lru_bwd.py``), so that the order is proven before the card.
Nothing here reaches a CUDA kernel.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru_scan
from repro_torch.kernels.ref import ref_rglru_scan, ref_rglru_scan_bwd

torch.set_num_threads(2)  # several test processes share the cores

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
# test_torch_scan.py's RG-LRU shapes (B, L, D) with the Pallas blocks (block_d, chunk).
LRU_SHAPES = [(2, 256, 64, 32, 64), (1, 96, 48, 48, 32)]
# Off the rounds and chunks: several rounds, one short round, a chunk's
# worth of steps past the end.
RAGGED = [(2, 1000, 24), (1, 33, 5), (1, 300, 7)]
BWD_SHAPES = [(2, 256, 64), (1, 96, 48), (2, 1000, 24), (1, 33, 5)]
REL = 1e-4  # the backward's bar: 1e-4 of the largest gradient


def chunking(source: str) -> tuple[int, int]:
    """(WARPS, CH) of a kernel source: chunks a round, steps a chunk."""
    text = (CSRC / source).read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                 for k in ("WARPS", "CH"))


def _fma(a, x, b):
    """fmaf in fp32: the product exact in fp64 and the sum rounded (once in
    fp64, then to fp32)."""
    return (a.double() * x.double() + b.double()).float()


def _chunked(t, n, ch):
    """(B, L, D) fp32, zeros past L up to n steps, as (B, n / ch, ch, D)."""
    B, L, D = t.shape
    return F.pad(t.float(), (0, 0, 0, n - L)).view(B, n // ch, ch, D)


def chunked_scan(a, b):
    """(h_all, h_final) in the forward kernel's order: each chunk from a zero
    carry (u, A), the carries chunk after chunk (a round's fold starts from
    the last round's end, so it runs on across rounds), each chunk again
    from its carry-in.  Steps past L read a = b = 0, as TMA's fill gives."""
    warps, ch = chunking("rglru_scan.cu")
    B, L, D = a.shape
    n = -(-L // (warps * ch)) * warps * ch
    a4, b4 = _chunked(a, n, ch), _chunked(b, n, ch)
    u, A = torch.zeros_like(a4[:, :, 0]), torch.ones_like(a4[:, :, 0])
    for j in range(ch):
        u, A = _fma(a4[:, :, j], u, b4[:, :, j]), A * a4[:, :, j]
    xin, x = torch.empty_like(u), torch.zeros_like(u[:, 0])
    for c in range(n // ch):
        xin[:, c], x = x, _fma(A[:, c], x, u[:, c])
    h, out = xin, torch.empty_like(a4)
    for j in range(ch):
        h = out[:, :, j] = _fma(a4[:, :, j], h, b4[:, :, j])
    h_all = out.view(B, n, D)[:, :L]
    return h_all, h_all[:, L - 1]


def chunked_scan_bwd(a, h_all, dh_all, dh_final=None):
    """(da, db) in fp32 in the backward kernel's order: each chunk back from
    a zero carry (dh_final entering at step L - 1), the carries composed from
    the last chunk to the first, each chunk back again from its carry-in,
    writing db = g and da = g h_{t-1}."""
    warps, ch = chunking("rglru_scan_bwd.cu")
    B, L, D = a.shape
    n = -(-L // (warps * ch)) * warps * ch
    a4, d4 = _chunked(a, n, ch), _chunked(dh_all, n, ch)
    hp4 = _chunked(F.pad(h_all.float(), (0, 0, 1, 0))[:, :L], n, ch)  # h_{t-1}, h_{-1} = 0
    wf = torch.zeros_like(a4[:, 0, 0]) if dh_final is None else dh_final.float()
    steps = torch.arange(n).view(n // ch, ch)

    def walk(w, j):  # step j of every chunk: (g, what it passes back)
        last = (steps[:, j] == L - 1)[None, :, None]
        w = torch.where(last, wf[:, None], w)
        g = d4[:, :, j] + w
        return g, a4[:, :, j] * g

    w, A = torch.zeros_like(a4[:, :, 0]), torch.ones_like(a4[:, :, 0])
    for j in reversed(range(ch)):
        w, A = walk(w, j)[1], A * a4[:, :, j]
    xin, x = torch.empty_like(w), torch.zeros_like(w[:, 0])
    for c in reversed(range(n // ch)):
        xin[:, c], x = x, _fma(A[:, c], x, w[:, c])
    w, da, db = xin, torch.empty_like(a4), torch.empty_like(a4)
    for j in reversed(range(ch)):
        g, w = walk(w, j)
        db[:, :, j], da[:, :, j] = g, g * hp4[:, :, j]
    return da.view(B, n, D)[:, :L], db.view(B, n, D)[:, :L]


def _lru_inputs(seed, B, L, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 0.99, (B, L, D)).astype(dtype),
            rng.standard_normal((B, L, D)).astype(dtype))


def _lru_tol(dtype):  # test_torch_scan.py's
    return dict(rtol=1e-5, atol=1e-5) if dtype == np.float32 else dict(rtol=5e-3, atol=5e-3)


def test_the_kernels_share_their_chunking():
    """Both kernels cut time alike, and a round is a whole number of chunks
    the model reads from the sources."""
    fwd, bwd = chunking("rglru_scan.cu"), chunking("rglru_scan_bwd.cu")
    assert fwd == bwd and min(fwd) >= 1
    assert "fmaf(sA[k * CPB + lane], x, su[k * CPB + lane])" in (CSRC / "rglru_scan.cu").read_text()
    assert "for (int k = WARPS - 1; k >= 0; --k)" in (CSRC / "rglru_scan_bwd.cu").read_text()


@pytest.mark.parametrize("target", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("B,L,D,block_d,chunk", LRU_SHAPES)
def test_chunked_scan_matches_jax(target, B, L, D, block_d, chunk, dtype):
    a, b = _lru_inputs(0, B, L, D, dtype)
    if target == "jax_ref":
        eh, ef = jref.ref_rglru_scan(jnp.asarray(a), jnp.asarray(b))
    else:
        eh, ef = pallas_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_d=block_d,
                                   chunk=chunk, interpret=True)
    h, f = chunked_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert h.dtype == torch.float32 and h.shape == (B, L, D) and f.shape == (B, D)
    np.testing.assert_allclose(h.numpy(), np.asarray(eh), **_lru_tol(dtype))
    np.testing.assert_allclose(f.numpy(), np.asarray(ef), **_lru_tol(dtype))


@pytest.mark.parametrize("B,L,D", RAGGED)
def test_chunked_scan_ragged_matches_jax_oracle(B, L, D):
    a, b = _lru_inputs(1, B, L, D)
    eh, ef = jref.ref_rglru_scan(jnp.asarray(a), jnp.asarray(b))
    h, f = chunked_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(h.numpy(), np.asarray(eh), **_lru_tol(np.float32))
    np.testing.assert_allclose(f.numpy(), np.asarray(ef), **_lru_tol(np.float32))


def _jax_grads(a, b, dh_all, dh_final):
    _, vjp = jax.vjp(jref.ref_rglru_scan, jnp.asarray(a), jnp.asarray(b))
    return [np.asarray(g) for g in vjp((jnp.asarray(dh_all), jnp.asarray(dh_final)))]


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("B,L,D", BWD_SHAPES)
def test_chunked_scan_bwd_matches_jax_vjp(B, L, D, with_dh):
    """On the model's own h_all, as the backward kernel gets the forward
    kernel's."""
    a, b = _lru_inputs(2, B, L, D)
    rng = np.random.default_rng(3)
    dh_all = rng.standard_normal((B, L, D)).astype(np.float32)
    dh_final = rng.standard_normal((B, D)).astype(np.float32)
    h_all, _ = chunked_scan(torch.from_numpy(a), torch.from_numpy(b))
    expect = _jax_grads(a, b, dh_all, dh_final if with_dh else np.zeros_like(dh_final))
    got = chunked_scan_bwd(torch.from_numpy(a), h_all, torch.from_numpy(dh_all),
                           torch.from_numpy(dh_final) if with_dh else None)
    for name, g, e in zip(("da", "db"), got, expect):
        assert g.dtype == torch.float32 and g.shape == e.shape, name
        assert float(np.abs(g.numpy() - e).max()) <= REL * float(np.abs(e).max()), name


@pytest.mark.parametrize("with_dh", [False, True])
def test_chunked_scan_bwd_takes_bf16_a(with_dh):
    """bf16 a and b (the fp32 walk of their fp32 copies, as the kernel's):
    against jax.vjp on those copies, at the same bar."""
    a, b = _lru_inputs(4, 2, 300, 40)
    at, bt = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    rng = np.random.default_rng(5)
    dh_all = rng.standard_normal(a.shape).astype(np.float32)
    dh_final = rng.standard_normal((2, 40)).astype(np.float32)
    h_all, _ = chunked_scan(at, bt)
    expect = _jax_grads(at.float().numpy(), bt.float().numpy(), dh_all,
                        dh_final if with_dh else np.zeros_like(dh_final))
    got = chunked_scan_bwd(at, h_all, torch.from_numpy(dh_all),
                           torch.from_numpy(dh_final) if with_dh else None)
    for name, g, e in zip(("da", "db"), got, expect):
        assert float(np.abs(g.numpy() - e).max()) <= REL * float(np.abs(e).max()), name


def test_chunked_scans_match_the_plain_walks_over_many_rounds():
    """recurrentgemma-9b's training length (32 rounds of 128 steps) at a few
    channels: the chunked order against the port's plain walks, at the
    forward's and the backward's bars."""
    a, b = _lru_inputs(6, 1, 4096, 8)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    h, f = chunked_scan(at, bt)
    eh, ef = ref_rglru_scan(at, bt)
    torch.testing.assert_close(h, eh, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f, ef, rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(7)
    dh, dhf = torch.randn(1, 4096, 8, generator=gen), torch.randn(1, 8, generator=gen)
    for g, e in zip(chunked_scan_bwd(at, h, dh, dhf), ref_rglru_scan_bwd(at, h, dh, dhf)):
        assert float((g - e).abs().max()) <= REL * float(e.abs().max())
