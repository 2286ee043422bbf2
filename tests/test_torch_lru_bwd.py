"""The RG-LRU scan's backward against the JAX package, on the CPU.

``ref_rglru_scan_bwd`` (the plain version of ``csrc/rglru_scan_bwd.cu``)
against ``jax.vjp`` of the reference's ``ref_rglru_scan`` on the RG-LRU
shapes of ``test_torch_scan.py`` and L = 1000 (off every 32-step chunk),
with and without a gradient for the final state, and with bf16 ``a``;
:class:`LruScanFn` on the plain versions against autograd of
``ref_rglru_scan``, alone and under non-reentrant checkpointing (remat
"full": the forward, and the h_all it saves, recomputed just before the
backward); ``ops.lru_scan`` under grad; and the CUDA wrapper's refusal of CPU
tensors.  Nothing here reaches a CUDA kernel: the card's side is
``chip_smoke.py`` and the ``gpu`` tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels.ref import ref_rglru_scan, ref_rglru_scan_bwd
from repro_torch.kernels.rglru_scan import LruScanFn, rglru_scan_bwd

torch.set_num_threads(2)  # several test processes share the cores

# test_torch_scan.py's RG-LRU shapes (B, L, D) and a ragged L = 1000.
SHAPES = [(2, 256, 64), (1, 96, 48), (2, 1000, 24)]
# The bar: 1e-4 of the largest gradient (the forward is held at 1e-5
# element-wise; the backward's sums over up to L steps run in another order).
REL = 1e-4


def _inputs(seed, B, L, D):
    """a, b as test_torch_scan.py draws them, and the cotangents of h_all and
    h_final."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 0.99, (B, L, D)).astype(np.float32),
            rng.standard_normal((B, L, D)).astype(np.float32),
            rng.standard_normal((B, L, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


def _jax_grads(a, b, dh_all, dh_final):
    _, vjp = jax.vjp(jref.ref_rglru_scan, jnp.asarray(a), jnp.asarray(b))
    return [np.asarray(g) for g in vjp((jnp.asarray(dh_all), jnp.asarray(dh_final)))]


def _assert_close(got, want, name):
    got = np.asarray(got, dtype=np.float32)
    bar = REL * float(np.abs(want).max())
    assert got.shape == want.shape, name
    assert float(np.abs(got - want).max()) <= bar, name


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("B,L,D", SHAPES)
def test_ref_rglru_scan_bwd_matches_jax_vjp(B, L, D, with_dh):
    a, b, dh_all, dh_final = _inputs(0, B, L, D)
    h_all, _ = ref_rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    expect = _jax_grads(a, b, dh_all, dh_final if with_dh else np.zeros_like(dh_final))
    got = ref_rglru_scan_bwd(torch.from_numpy(a), h_all, torch.from_numpy(dh_all),
                             torch.from_numpy(dh_final) if with_dh else None)
    for name, g, e in zip(("da", "db"), got, expect):
        assert g.dtype == torch.float32, name
        _assert_close(g.numpy(), e, name)


@pytest.mark.parametrize("with_dh", [False, True])
def test_ref_rglru_scan_bwd_takes_bf16_a(with_dh):
    """bf16 a and b, as a bf16 caller would pass them: the fp32 walk of their
    fp32 copies, rounded once to bf16; that walk matches jax.vjp within the
    bar, and the bf16 gradients within it plus one rounding."""
    a, b, dh_all, dh_final = _inputs(1, 2, 300, 40)
    at, bt = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    h_all, _ = ref_rglru_scan(at, bt)
    dhf = torch.from_numpy(dh_final) if with_dh else None
    got = ref_rglru_scan_bwd(at, h_all, torch.from_numpy(dh_all), dhf)
    exact = ref_rglru_scan_bwd(at.float(), h_all, torch.from_numpy(dh_all), dhf)
    expect = _jax_grads(at.float().numpy(), bt.float().numpy(), dh_all,
                        dh_final if with_dh else np.zeros_like(dh_final))
    for name, g, x, e in zip(("da", "db"), got, exact, expect):
        assert g.dtype == torch.bfloat16, name
        assert torch.equal(g, x.bfloat16()), name
        _assert_close(x.numpy(), e, name)
        bar = REL * np.abs(e).max() + 2.0**-7 * np.abs(e)
        assert np.all(np.abs(g.float().numpy() - e) <= bar), name


@pytest.mark.parametrize("with_dh", [False, True])
def test_lru_scan_fn_on_cpu_matches_autograd_of_the_plain_scan(with_dh):
    """The Function's backward on the CPU (``ref_rglru_scan_bwd``) against
    autograd through ``ref_rglru_scan``'s loop; an unused h_final gets None."""
    a, b, dh_all, dh_final = (torch.from_numpy(x) for x in _inputs(2, 2, 70, 16))
    leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    h, f = LruScanFn.apply(*leaves)
    eh, ef = ref_rglru_scan(*leaves)
    assert torch.equal(h, eh) and torch.equal(f, ef)
    outs, eouts, cots = ((h, f), (eh, ef), (dh_all, dh_final)) if with_dh else (
        (h,), (eh,), (dh_all,))
    got = torch.autograd.grad(outs, leaves, cots)
    expect = torch.autograd.grad(eouts, leaves, cots)
    for name, g, e in zip(("da", "db"), got, expect):
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("B,L,D", [(2, 40, 24), (1, 1000, 24)])
def test_lru_scan_fn_under_remat_matches_autograd_of_the_plain_scan(B, L, D, with_dh):
    """The Function as the model trains it under remat "full": inside
    non-reentrant ``torch.utils.checkpoint``, whose first forward's saved
    tensors (a and h_all) are dropped and recomputed before the backward."""
    a, b, dh_all, dh_final = (torch.from_numpy(x) for x in _inputs(3, B, L, D))
    leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    h, f = checkpoint(LruScanFn.apply, *leaves, use_reentrant=False)
    eh, ef = ref_rglru_scan(*leaves)
    assert torch.equal(h, eh) and torch.equal(f, ef)
    outs, eouts, cots = ((h, f), (eh, ef), (dh_all, dh_final)) if with_dh else (
        (h,), (eh,), (dh_all,))
    got = torch.autograd.grad(outs, leaves, cots)
    expect = torch.autograd.grad(eouts, leaves, cots)
    for name, g, e in zip(("da", "db"), got, expect):
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-5, msg=name)


def test_lru_scan_fn_gives_only_the_gradients_asked_for():
    a, b, dh_all, _ = (torch.from_numpy(x) for x in _inputs(4, 1, 20, 8))
    b.requires_grad_(True)
    h, _ = LruScanFn.apply(a, b)
    (gb,) = torch.autograd.grad(h, [b], dh_all)
    assert torch.equal(gb, ref_rglru_scan_bwd(a, h.detach(), dh_all)[1])


def test_ops_lru_scan_under_grad_takes_the_function_and_counts_no_launch(monkeypatch):
    """On the CPU, under grad, ``ops.lru_scan`` goes through the Function on
    the plain versions: the plain scan's outputs, the plain backward's
    gradients, and no CUDA launch counted or built."""
    for name in ("lru_scan_launches", "lru_scan_bwd_launches"):
        monkeypatch.setattr(ops, name, 0)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    a, b, dh_all, _ = (torch.from_numpy(x) for x in _inputs(5, 2, 30, 16))
    leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    h, _ = ops.lru_scan(*leaves)
    assert type(h.grad_fn).__name__ == "LruScanFnBackward"
    assert torch.equal(h, ref_rglru_scan(a, b)[0])
    got = torch.autograd.grad(h, leaves, dh_all)
    for g, e in zip(got, ref_rglru_scan_bwd(a, h.detach(), dh_all)):
        assert torch.equal(g, e)
    with torch.no_grad():
        assert ops.lru_scan(*leaves)[0].grad_fn is None
    assert ops.lru_scan_launches == 0 and ops.lru_scan_bwd_launches == 0


def test_bwd_wrapper_refuses_cpu_tensors_before_any_build(monkeypatch):
    """The CUDA wrapper never computes on the CPU, whatever the dtypes or
    shapes it is given, and raises before it builds anything; its dtype and
    shape checks on the card are in test_torch_gpu.py."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    a, b, dh_all, dh_final = (torch.from_numpy(x) for x in _inputs(6, 1, 8, 16))
    h_all, _ = ref_rglru_scan(a, b)
    for call in ((a, h_all, dh_all), (a, h_all, dh_all, dh_final), (a.bfloat16(), h_all, dh_all),
                 (a, h_all, dh_all.double()), (a, h_all, dh_all[:, :4])):
        with pytest.raises(ValueError, match="CUDA"):
            rglru_scan_bwd(*call)
