"""The Mamba scan's backward against the JAX package, on the CPU.

``ref_mamba_scan_bwd`` (the plain version of ``csrc/mamba_scan_bwd.cu``)
against ``jax.vjp`` of the reference's ``ref_mamba_scan`` on the shapes of
``test_torch_scan.py`` (the Pallas blocks' and L = 1000, off every chunk),
with and without a gradient for the final state, and with bf16 inputs whose
b and c are strided slices of one projection; :class:`SelectiveScanFn` on the
plain versions against autograd of ``ref_mamba_scan``, alone and under
non-reentrant checkpointing (remat "full": the forward, and the checkpoints
it saves, recomputed just before the backward); ``ops.selective_scan`` under
grad; and the CUDA wrapper's refusal of CPU tensors.  Nothing here
reaches a CUDA kernel: the card's side is ``chip_smoke.py`` and the ``gpu``
tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels.mamba_scan import SelectiveScanFn, mamba_scan_bwd
from repro_torch.kernels.ref import ckpt_shape, ref_mamba_scan, ref_mamba_scan_bwd

torch.set_num_threads(2)  # several test processes share the cores

# test_torch_scan.py's shapes (B, L, DI, ST): the Pallas blocks' and a
# ragged L = 1000; its bar (the sums run in another order than JAX's).
SHAPES = [(2, 256, 64, 8), (1, 128, 128, 16), (3, 64, 32, 4), (2, 1000, 24, 16)]
MAMBA_TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("dxc", "ddt", "da", "db", "dc", "dd")


def _inputs(seed, B, L, DI, ST):
    """The scan's inputs (as test_torch_scan.py draws them), dy and dh."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, L, DI)).astype(np.float32),
        rng.uniform(0.001, 0.1, (B, L, DI)).astype(np.float32),
        -rng.uniform(0.5, 2.0, (DI, ST)).astype(np.float32),
        rng.standard_normal((B, L, ST)).astype(np.float32),
        rng.standard_normal((B, L, ST)).astype(np.float32),
        rng.standard_normal((DI,)).astype(np.float32),
    ), rng.standard_normal((B, L, DI)).astype(np.float32), rng.standard_normal(
        (B, DI, ST)).astype(np.float32)


def _detached(leaves):
    return [t.detach() for t in leaves]


def _jax_grads(args, dy, dh):
    """jax.vjp of the reference's scan with cotangents (dy, dh)."""
    _, vjp = jax.vjp(jref.ref_mamba_scan, *(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("B,L,DI,ST", SHAPES)
def test_ref_mamba_scan_bwd_matches_jax_vjp(B, L, DI, ST, with_dh):
    args, dy, dh = _inputs(0, B, L, DI, ST)
    expect = _jax_grads(args, dy, dh if with_dh else np.zeros_like(dh))
    got = ref_mamba_scan_bwd(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
                             torch.from_numpy(dh) if with_dh else None)
    for name, g, e in zip(NAMES, got, expect):
        assert g.dtype == torch.float32 and g.shape == e.shape, name
        np.testing.assert_allclose(g.numpy(), e, **MAMBA_TOL, err_msg=name)


def test_ref_mamba_scan_bwd_takes_bf16_inputs_and_strided_b_c():
    """bf16 xc, b, c as the bf16 model passes them, b and c slices of one
    (B, L, R + 2 ST) projection: the fp32 sums of their fp32 copies, rounded
    once to bf16 (dxc, db, dc); those sums match jax.vjp within MAMBA_TOL."""
    B, L, DI, ST, R = 2, 50, 16, 8, 4
    (xc, dt, a, _, _, d), dy, dh = _inputs(2, B, L, DI, ST)
    rng = np.random.default_rng(3)
    xdbc = torch.from_numpy(rng.standard_normal((B, L, R + 2 * ST)).astype(np.float32))
    xdbc = xdbc.bfloat16()
    b, c = xdbc[..., R:R + ST], xdbc[..., R + ST:]
    assert not b.is_contiguous()
    xc_t = torch.from_numpy(xc).bfloat16()
    rest = (torch.from_numpy(dt), torch.from_numpy(a))
    got = ref_mamba_scan_bwd(xc_t, *rest, b, c, torch.from_numpy(d), torch.from_numpy(dy),
                             torch.from_numpy(dh))
    sums = ref_mamba_scan_bwd(xc_t.float(), *rest, b.float(), c.float(), torch.from_numpy(d),
                              torch.from_numpy(dy), torch.from_numpy(dh))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16, torch.float32]
    for name, g, s in zip(NAMES, got, sums):
        assert torch.equal(g, s.to(g.dtype)), name
    expect = _jax_grads([xc_t.float().numpy(), dt, a, b.float().numpy(), c.float().numpy(), d],
                        dy, dh)
    for name, s, e in zip(NAMES, sums, expect):
        np.testing.assert_allclose(s.numpy(), e, **MAMBA_TOL, err_msg=name)


@pytest.mark.parametrize("with_dh", [False, True])
def test_selective_scan_fn_on_cpu_matches_autograd_of_the_plain_scan(with_dh):
    """The Function's backward on the CPU (``ref_mamba_scan_bwd``) against
    autograd through ``ref_mamba_scan``'s loop; an unused h_final gets None."""
    args, dy, dh = _inputs(4, 2, 40, 24, 16)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = SelectiveScanFn.apply(*leaves)
    ey, eh = ref_mamba_scan(*leaves)
    assert torch.equal(y, ey) and torch.equal(h, eh)
    outs, cots = ((y, h), (torch.from_numpy(dy), torch.from_numpy(dh))) if with_dh else (
        (y,), (torch.from_numpy(dy),))
    got = torch.autograd.grad(outs, leaves, cots)
    eouts = (ey, eh) if with_dh else (ey,)
    expect = torch.autograd.grad(eouts, leaves, cots)
    for name, g, e in zip(NAMES, got, expect):
        torch.testing.assert_close(g, e, **MAMBA_TOL, msg=name)


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("B,L,DI,ST", [(2, 40, 24, 16), (2, 1000, 24, 16)])
def test_selective_scan_fn_under_remat_matches_autograd_of_the_plain_scan(B, L, DI, ST, with_dh):
    """The Function as the model trains it under remat "full": inside
    non-reentrant ``torch.utils.checkpoint``, whose first forward's saved
    tensors (the checkpoints among them) are dropped and recomputed before
    the backward.  Its gradients match autograd through ``ref_mamba_scan``'s
    loop, with and without a gradient for h_final, at L off every 8-step
    chunk."""
    args, dy, dh = _inputs(8, B, L, DI, ST)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = checkpoint(SelectiveScanFn.apply, *leaves, use_reentrant=False)
    ey, eh = ref_mamba_scan(*leaves)
    assert torch.equal(y, ey) and torch.equal(h, eh)
    cots = (torch.from_numpy(dy), torch.from_numpy(dh))
    got = torch.autograd.grad((y, h) if with_dh else (y,), leaves, cots if with_dh else cots[:1])
    expect = torch.autograd.grad((ey, eh) if with_dh else (ey,), leaves,
                                 cots if with_dh else cots[:1])
    for name, g, e in zip(NAMES, got, expect):
        torch.testing.assert_close(g, e, **MAMBA_TOL, msg=name)


def test_selective_scan_fn_under_remat_takes_bf16_inputs_and_strided_b_c():
    """Under remat with bf16 xc, b, c, b and c slices of one projection: the
    gradients are the plain backward's on the same inputs (to the bit), and
    those match jax.vjp of the reference's scan on their fp32 copies within
    MAMBA_TOL (dxc, db, dc after their one rounding to bf16)."""
    B, L, DI, ST, R = 2, 50, 16, 8, 4
    (xc, dt, a, _, _, d), dy, dh = _inputs(9, B, L, DI, ST)
    rng = np.random.default_rng(10)
    xdbc = torch.from_numpy(rng.standard_normal((B, L, R + 2 * ST)).astype(np.float32))
    xdbc = xdbc.bfloat16().requires_grad_(True)
    b, c = xdbc[..., R:R + ST], xdbc[..., R + ST:]
    assert not b.is_contiguous()
    xc_t = torch.from_numpy(xc).bfloat16().requires_grad_(True)
    rest = [torch.from_numpy(t).requires_grad_(True) for t in (dt, a)]
    d_t = torch.from_numpy(d).requires_grad_(True)
    y, h = checkpoint(SelectiveScanFn.apply, xc_t, *rest, b, c, d_t, use_reentrant=False)
    got = torch.autograd.grad((y, h), [xc_t, *rest, b, c, d_t],
                              (torch.from_numpy(dy), torch.from_numpy(dh)))
    detached = [t.detach() for t in (xc_t, *rest, b, c, d_t)]
    plain = ref_mamba_scan_bwd(*detached, torch.from_numpy(dy), torch.from_numpy(dh))
    for name, g, e in zip(NAMES, got, plain):
        assert torch.equal(g, e), name
    expect = _jax_grads([xc_t.detach().float().numpy(), dt, a, b.detach().float().numpy(),
                         c.detach().float().numpy(), d], dy, dh)
    for name, g, e in zip(NAMES, got, expect):
        rounding = 2.0**-7 * np.abs(e) if g.dtype == torch.bfloat16 else 0.0
        assert np.all(np.abs(g.float().numpy() - e) <= 1e-4 + 1e-4 * np.abs(e) + rounding), name


def test_selective_scan_fn_gives_only_the_gradients_asked_for():
    args, dy, _ = _inputs(5, 1, 20, 8, 4)
    xc, *rest = (torch.from_numpy(a) for a in args)
    xc.requires_grad_(True)
    y, _ = SelectiveScanFn.apply(xc, *rest)
    (gx,) = torch.autograd.grad(y, [xc], torch.from_numpy(dy))
    expect = ref_mamba_scan_bwd(xc.detach(), *rest, torch.from_numpy(dy))[0]
    assert torch.equal(gx, expect)


def test_ops_selective_scan_under_grad_takes_the_function_and_counts_no_launch(monkeypatch):
    """On the CPU, under grad, ``ops.selective_scan`` goes through the Function
    on the plain versions: the same outputs as the plain scan, the plain
    backward's gradients, and no CUDA launch counted or built."""
    for name in ("selective_scan_launches", "selective_scan_bwd_launches"):
        monkeypatch.setattr(ops, name, 0)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    args, dy, _ = _inputs(6, 2, 30, 16, 8)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = ops.selective_scan(*leaves)
    assert type(y.grad_fn).__name__ == "SelectiveScanFnBackward"
    assert torch.equal(y, ref_mamba_scan(*_detached(leaves))[0])
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    expect = ref_mamba_scan_bwd(*_detached(leaves), torch.from_numpy(dy))
    for name, g, e in zip(NAMES, got, expect):
        assert torch.equal(g, e), name
    with torch.no_grad():
        assert ops.selective_scan(*leaves)[0].grad_fn is None
    assert ops.selective_scan_launches == 0 and ops.selective_scan_bwd_launches == 0


def test_bwd_wrapper_refuses_cpu_tensors_before_any_build(monkeypatch):
    """The CUDA wrapper never computes on the CPU, whatever the dtypes or
    shapes it is given, and raises before it builds anything; the wrappers'
    dtype and shape checks on the card are in test_torch_gpu.py."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    args, dy, dh = _inputs(7, 1, 8, 16, 8)
    args = [torch.from_numpy(a) for a in args]
    dy, dh = torch.from_numpy(dy), torch.from_numpy(dh)
    ck = torch.zeros(ckpt_shape(1, 8, 16, 8))
    for call in ((*args, dy, None, ck), (*args, dy, dh, ck),
                 (args[0].half(), *args[1:], dy, None, ck),
                 (*args, dy.double(), None, ck), (*args, dy[:, :4], None, ck)):
        with pytest.raises(ValueError, match="CUDA"):
            mamba_scan_bwd(*call)
