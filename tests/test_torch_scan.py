"""The port's plain scans against the JAX package: ``ref_mamba_scan`` and
``ref_rglru_scan`` against JAX's oracles and its Pallas kernels (interpret
mode), on the shapes and tolerances of test_kernels.py, plus ragged lengths
the Pallas wrappers cannot take (they assert ``L % chunk == 0``), and the
wrappers' CPU behaviour."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba_scan
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru_scan
from repro_torch.kernels import _build, ops
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.ref import CKPT_STEPS, ckpt_shape, ref_mamba_scan, ref_rglru_scan
from repro_torch.kernels.rglru_scan import rglru_scan

torch.set_num_threads(2)  # several test processes share the cores

# test_kernels.py:61-65, (B, L, DI, ST) with the Pallas blocks (block_d, chunk).
MAMBA_SHAPES = [(2, 256, 64, 8, 32, 64), (1, 128, 128, 16, 128, 128), (3, 64, 32, 4, 16, 32)]
# test_kernels.py:80-81, (B, L, D) with (block_d, chunk).
LRU_SHAPES = [(2, 256, 64, 32, 64), (1, 96, 48, 48, 32)]
# test_kernels.py's bars: the mamba scan's fp32 sums over ST in another order.
MAMBA_TOL = dict(rtol=1e-4, atol=1e-4)


def _lru_tol(dtype):
    return dict(rtol=1e-5, atol=1e-5) if dtype == np.float32 else dict(rtol=5e-3, atol=5e-3)


def _mamba_inputs(seed, B, L, DI, ST, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, L, DI)).astype(dtype),
        rng.uniform(0.001, 0.1, (B, L, DI)).astype(np.float32),
        -rng.uniform(0.5, 2.0, (DI, ST)).astype(np.float32),
        rng.standard_normal((B, L, ST)).astype(dtype),
        rng.standard_normal((B, L, ST)).astype(dtype),
        rng.standard_normal((DI,)).astype(np.float32),
    )


def _lru_inputs(seed, B, L, D, dtype):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(0.1, 0.99, (B, L, D)).astype(dtype),
        rng.standard_normal((B, L, D)).astype(dtype),
    )


def _port_mamba(inputs):
    y, h = ref_mamba_scan(*(torch.from_numpy(a) for a in inputs))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("target", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("B,L,DI,ST,block_d,chunk", MAMBA_SHAPES)
def test_ref_mamba_scan_matches_jax(target, B, L, DI, ST, block_d, chunk):
    inputs = _mamba_inputs(0, B, L, DI, ST)
    args = [jnp.asarray(a) for a in inputs]
    if target == "jax_ref":
        ey, eh = jref.ref_mamba_scan(*args)
    else:
        ey, eh = pallas_mamba_scan(*args, block_d=block_d, chunk=chunk, interpret=True)
    y, h = _port_mamba(inputs)
    np.testing.assert_allclose(y, np.asarray(ey), **MAMBA_TOL)
    np.testing.assert_allclose(h, np.asarray(eh), **MAMBA_TOL)


@pytest.mark.parametrize("B,L,DI,ST", [(2, 1000, 24, 16), (1, 37, 40, 16), (3, 1, 8, 5)])
def test_ref_mamba_scan_ragged_matches_jax_oracle(B, L, DI, ST):
    """L = 1000 (falcon-mamba's serving prompt) is no multiple of the Pallas chunk."""
    inputs = _mamba_inputs(1, B, L, DI, ST)
    ey, eh = jref.ref_mamba_scan(*(jnp.asarray(a) for a in inputs))
    y, h = _port_mamba(inputs)
    np.testing.assert_allclose(y, np.asarray(ey), **MAMBA_TOL)
    np.testing.assert_allclose(h, np.asarray(eh), **MAMBA_TOL)


def test_ref_mamba_scan_takes_bf16_inputs_and_strided_b_c():
    """bf16 xc, b, c as the bf16 model passes them, b and c as slices of one
    (B, L, R + 2 ST) projection: the same numbers as contiguous fp32 copies."""
    B, L, DI, ST, R = 2, 50, 16, 8, 4
    rng = np.random.default_rng(2)
    xc, dt, a, _, _, d = _mamba_inputs(2, B, L, DI, ST)
    xdbc = torch.from_numpy(rng.standard_normal((B, L, R + 2 * ST)).astype(np.float32))
    xdbc = xdbc.bfloat16()
    b, c = xdbc[..., R:R + ST], xdbc[..., R + ST:]
    assert not b.is_contiguous()
    xc_t = torch.from_numpy(xc).bfloat16()
    y, h = ref_mamba_scan(xc_t, torch.from_numpy(dt), torch.from_numpy(a), b, c,
                          torch.from_numpy(d))
    args = [xc_t.float().numpy(), dt, a, b.float().numpy(), c.float().numpy(), d]
    ey, eh = jref.ref_mamba_scan(*(jnp.asarray(x) for x in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), **MAMBA_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(eh), **MAMBA_TOL)


@pytest.mark.parametrize("target", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("B,L,D,block_d,chunk", LRU_SHAPES)
def test_ref_rglru_scan_matches_jax(target, B, L, D, block_d, chunk, dtype):
    a, b = _lru_inputs(0, B, L, D, dtype)
    if target == "jax_ref":
        eh, ef = jref.ref_rglru_scan(jnp.asarray(a), jnp.asarray(b))
    else:
        eh, ef = pallas_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_d=block_d,
                                   chunk=chunk, interpret=True)
    h, f = ref_rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert h.dtype == torch.float32 and f.shape == (B, D)
    np.testing.assert_allclose(h.numpy(), np.asarray(eh), **_lru_tol(dtype))
    np.testing.assert_allclose(f.numpy(), np.asarray(ef), **_lru_tol(dtype))


@pytest.mark.parametrize("B,L,D", [(4, 2048, 8), (2, 1000, 24), (1, 33, 5)])
def test_ref_rglru_scan_ragged_matches_jax_oracle(B, L, D):
    a, b = _lru_inputs(1, B, L, D, np.float32)
    eh, ef = jref.ref_rglru_scan(jnp.asarray(a), jnp.asarray(b))
    h, f = ref_rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(h.numpy(), np.asarray(eh), **_lru_tol(np.float32))
    np.testing.assert_allclose(f.numpy(), np.asarray(ef), **_lru_tol(np.float32))


# The checkpoints' shapes: the Pallas blocks', a ragged L = 1000 (off every
# 8-step chunk), fewer states than the checkpoints' rounding to 4, and one
# chunk or less (no checkpoint).
CKPT_SHAPES = [(2, 256, 64, 8), (1, 128, 128, 16), (3, 64, 32, 4), (2, 1000, 24, 16),
               (1, 21, 8, 5), (2, 8, 8, 16)]


@pytest.mark.parametrize("B,L,DI,ST", CKPT_SHAPES)
def test_ref_mamba_scan_checkpoints_are_the_jax_states_after_each_chunk(B, L, DI, ST):
    """The plain forward with checkpoints (what ``SelectiveScanFn`` saves on
    the CPU): y and h bitwise what the serving call returns, and checkpoint
    k the final h of JAX's ``ref_mamba_scan`` on the first 8 (k + 1) steps
    (the first two, a middle one and the last), states past ST zero."""
    inputs = _mamba_inputs(5, B, L, DI, ST)
    y, h, ckpt = ref_mamba_scan(*(torch.from_numpy(a) for a in inputs), checkpoints=True)
    assert ckpt.dtype == torch.float32
    assert ckpt.shape == ckpt_shape(B, L, DI, ST) == (B, -(-L // 8) - 1, DI, -(-ST // 4) * 4)
    ey, eh = ref_mamba_scan(*(torch.from_numpy(a) for a in inputs))
    assert torch.equal(y, ey) and torch.equal(h, eh)
    assert not ckpt[..., ST:].any()
    xc, dt, a, b, c, d = inputs
    n_ck = ckpt.shape[1]
    for k in sorted({0, 1, n_ck // 2, n_ck - 1} & set(range(n_ck))):
        n = CKPT_STEPS * (k + 1)
        _, jh = jref.ref_mamba_scan(*(jnp.asarray(t[:, :n]) for t in (xc, dt)), jnp.asarray(a),
                                    *(jnp.asarray(t[:, :n]) for t in (b, c)), jnp.asarray(d))
        np.testing.assert_allclose(ckpt[:, k, :, :ST].numpy(), np.asarray(jh), **MAMBA_TOL,
                                   err_msg=f"checkpoint {k}")


def test_ops_on_cpu_take_the_plain_path_and_count_no_launch(monkeypatch):
    monkeypatch.setattr(ops, "selective_scan_launches", 0)
    monkeypatch.setattr(ops, "lru_scan_launches", 0)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    m = [torch.from_numpy(x) for x in _mamba_inputs(3, 2, 20, 16, 8)]
    y, h = ops.selective_scan(*m)
    ey, eh = ref_mamba_scan(*m)
    assert torch.equal(y, ey) and torch.equal(h, eh)
    a, b = (torch.from_numpy(x) for x in _lru_inputs(3, 2, 20, 16, np.float32))
    ha, hf = ops.lru_scan(a, b)
    ea, ef = ref_rglru_scan(a, b)
    assert torch.equal(ha, ea) and torch.equal(hf, ef)
    assert ops.selective_scan_launches == 0 and ops.lru_scan_launches == 0


def test_kernel_wrappers_refuse_cpu_tensors(monkeypatch):
    """The CUDA wrappers never compute on the CPU, and raise before any build."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    m = [torch.from_numpy(x) for x in _mamba_inputs(4, 1, 8, 16, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan(*m)
    a, b = (torch.from_numpy(x) for x in _lru_inputs(4, 1, 8, 16, np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan(a, b)
