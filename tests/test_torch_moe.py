"""The port's grouped matmul and MoE layer against the JAX package: the plain
``ref_moe_gmm`` against JAX's oracle and its Pallas kernel (interpret mode),
on the shapes and tolerances of test_kernels.py, and ``moe`` against
``repro.models.layers.moe`` on the same weights, with and without drops."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ref as jref
from repro.kernels.moe_gmm import moe_gmm as pallas_moe_gmm
from repro.models import layers as jL
from repro_torch.configs import base as tbase
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import TILINGS, gmm_tiling, moe_gmm
from repro_torch.kernels.ref import ref_moe_gmm
from repro_torch.models import layers as L

torch.set_num_threads(2)  # several test processes share the cores

# test_kernels.py:96-106: (E, C, D, F) with the Pallas blocks (bc, bf, bd).
SHAPES = [(4, 128, 256, 128, 64, 64, 128), (8, 64, 64, 256, 64, 128, 64)]
# test_models_smoke.py's fp32 bar for the models.
FP32 = dict(rtol=2e-4, atol=2e-4)


def _tol(dtype):
    # test_kernels.py's bars: fp16 rounds the output, fp32 only reorders sums.
    return dict(rtol=2e-2, atol=2e-2) if dtype != np.float32 else dict(
        rtol=2e-5, atol=2e-5
    )


def _xw(seed, E, C, D, F, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(dtype)
    w = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(dtype)
    return x, w


def _port(x, w):
    out = ref_moe_gmm(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.from_numpy(x).dtype
    return out.float().numpy()


@pytest.mark.parametrize("target", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("E,C,D,F,bc,bf,bd", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_gmm_matches_jax(E, C, D, F, bc, bf, bd, dtype, target):
    x, w = _xw(0, E, C, D, F, dtype)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    if target == "jax_ref":
        expect = jref.ref_moe_gmm(jx, jw)
    else:
        expect = pallas_moe_gmm(jx, jw, block_c=bc, block_f=bf, block_d=bd, interpret=True)
    out = _port(x, w)
    assert out.shape == (E, C, F)
    np.testing.assert_allclose(out, np.asarray(expect, np.float32), **_tol(dtype))


@pytest.mark.parametrize("C", [1, 77])  # decode's C = 1; the Pallas wrapper rejects both
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_gmm_ragged_matches_jax_oracle(C, dtype):
    x, w = _xw(1, 3, C, 200, 136, dtype)
    expect = jref.ref_moe_gmm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(_port(x, w), np.asarray(expect, np.float32), **_tol(dtype))


GMM_COUNTERS = ("grouped_matmul_launches", "grouped_matmul_wgmma_launches",
                "grouped_matmul_fma_launches", "grouped_matmul_skinny_launches")


def test_grouped_matmul_on_cpu_runs_plain_and_counts_nothing(monkeypatch):
    for name in GMM_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    x, w = (torch.from_numpy(a) for a in _xw(2, 2, 5, 16, 8, np.float32))
    torch.testing.assert_close(ops.grouped_matmul(x, w), ref_moe_gmm(x, w), rtol=0, atol=0)
    assert all(getattr(ops, name) == 0 for name in GMM_COUNTERS)


@pytest.mark.parametrize("C", [1, 40])  # the skinny and the wgmma tilings' shapes on a card
def test_grouped_matmul_on_cpu_counts_no_tiling_in_bf16(monkeypatch, C):
    for name in GMM_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    x, w = (torch.from_numpy(a).to(torch.bfloat16) for a in _xw(2, 2, C, 64, 32, np.float32))
    torch.testing.assert_close(ops.grouped_matmul(x, w), ref_moe_gmm(x, w), rtol=0, atol=0)
    assert all(getattr(ops, name) == 0 for name in GMM_COUNTERS)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w = (torch.from_numpy(a) for a in _xw(2, 2, 5, 16, 8, np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm(x, w)


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrapper_refuses_cpu_tensors_for_every_tiling(tiling, dtype):
    x, w = (torch.from_numpy(a).to(dtype) for a in _xw(2, 2, 40, 64, 32, np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm(x, w, tiling=tiling)


@pytest.mark.parametrize(
    "dtype,C,D,F,want",
    [
        # qwen3-moe-30b-a3b at prefill (C = 312): gate/up and down products.
        (torch.bfloat16, 312, 2048, 768, "wgmma"),
        (torch.bfloat16, 312, 768, 2048, "wgmma"),
        (torch.float16, 312, 2048, 768, "wgmma"),
        (torch.float16, 312, 768, 2048, "wgmma"),
        (torch.float32, 312, 2048, 768, "fma"),
        (torch.float32, 312, 768, 2048, "fma"),
        # At decode (C = 1), and the skinny/tiled switch at C = 16.
        (torch.bfloat16, 1, 2048, 768, "skinny"),
        (torch.bfloat16, 1, 768, 2048, "skinny"),
        (torch.float32, 1, 2048, 768, "skinny"),
        (torch.bfloat16, 16, 2048, 768, "skinny"),
        (torch.bfloat16, 17, 2048, 768, "wgmma"),
        (torch.bfloat16, 5, 201, 135, "skinny"),
        # The skinny tiling stages x's rows in shared memory: D up to 32768.
        (torch.bfloat16, 1, 32768, 64, "skinny"),
        (torch.float32, 4, 32769, 64, "fma"),
        # The narrow MoE model's products (fp32) and ragged shapes: TMA
        # needs D and F to be multiples of 8.
        (torch.float32, 40, 256, 128, "fma"),
        (torch.bfloat16, 129, 72, 136, "wgmma"),
        (torch.bfloat16, 77, 200, 136, "wgmma"),
        (torch.bfloat16, 70, 201, 136, "fma"),
        (torch.float16, 70, 200, 135, "fma"),
        (torch.int8, 312, 2048, 768, ValueError),
    ],
)
def test_gmm_tiling(dtype, C, D, F, want):
    if isinstance(want, str):
        assert gmm_tiling(dtype, C, D, F) == want
    else:
        with pytest.raises(want):
            gmm_tiling(dtype, C, D, F)


def _moe_pair(capacity_factor, seed=0):
    """qwen3-moe's smoke layer in fp32 in both packages, on the same weights."""
    over = dict(param_dtype="float32", activation_dtype="float32",
                capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jbase.get_config("qwen3-moe-30b-a3b").smoke(), **over)
    tcfg = dataclasses.replace(tbase.get_config("qwen3-moe-30b-a3b").smoke(), **over)
    jp = jL.init_moe(jax.random.PRNGKey(seed), jcfg)
    mod = L.MoE(tcfg, torch.Generator().manual_seed(seed), torch.device("cpu"))
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jcfg, tcfg, jp, mod


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5], ids=["dropless", "drops"])
def test_moe_matches_reference_fp32(capacity_factor):
    jcfg, tcfg, jp, mod = _moe_pair(capacity_factor)
    x = np.random.default_rng(3).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    expect, expect_aux = jL.moe(jp, jnp.asarray(x), jcfg)
    out, aux = L.moe(mod, torch.from_numpy(x), tcfg)
    assert out.shape == (2, 24, tcfg.d_model) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **FP32)
    np.testing.assert_allclose(float(aux), float(expect_aux), **FP32)

    # The drop case really drops: some (token, expert) entry found its
    # expert's C slots full, so that token's output lacks its share.
    N, K, E = 48, tcfg.top_k, tcfg.n_experts
    C = max(1, int(capacity_factor * N * K / E))
    logits = torch.from_numpy(x.reshape(N, -1)) @ mod.router
    counts = torch.bincount(torch.topk(logits, K, dim=-1).indices.reshape(-1), minlength=E)
    assert bool((counts > C).any()) == (capacity_factor < 1.0)


def test_moe_init_matches_reference_layouts():
    cfg = tbase.get_config("qwen3-moe-30b-a3b").smoke()  # bf16 params
    jp = jL.init_moe(jax.random.PRNGKey(0), jbase.get_config("qwen3-moe-30b-a3b").smoke())
    mod = L.MoE(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    sd = mod.state_dict()
    assert sorted(sd) == sorted(jp)
    for name, t in sd.items():
        assert tuple(t.shape) == jp[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == jp[name].dtype.name, name
    assert sd["router"].dtype == torch.float32
    assert float(sd["norm"].abs().max()) == 0.0
    assert float(sd["wd"].float().abs().max()) <= 2.0 / np.sqrt(cfg.d_ff) + 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_decode_buffers_are_zero_for_experts_without_a_kept_entry(monkeypatch, dtype):
    """At qwen3-moe-30b-a3b's decode routing (E 128, top 8, 4 requests of one
    token, capacity 1.25: C = 1), every expert that keeps no (token, expert)
    entry has exactly zero rows in the gate/up input and in the down input.
    The skinny tiling's skip of all-zero rows relies on this."""
    full = tbase.get_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(
        full.smoke(), n_experts=full.n_experts, top_k=full.top_k,
        capacity_factor=full.capacity_factor, d_model=64, d_ff=32,
        param_dtype=str(dtype).removeprefix("torch."),
        activation_dtype=str(dtype).removeprefix("torch."),
    )
    mod = L.MoE(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 1, cfg.d_model))).to(dtype)
    seen = []
    real = ops.grouped_matmul

    def capture(xb, w):
        seen.append(xb.clone())
        return real(xb, w)

    monkeypatch.setattr(ops, "grouped_matmul", capture)
    L.moe(mod, x, cfg)
    E, K, N = cfg.n_experts, cfg.top_k, 4
    C = max(1, int(cfg.capacity_factor * N * K / E))
    assert C == 1 and len(seen) == 3
    gate_in, up_in, down_in = seen
    assert gate_in.shape == (E, C, cfg.d_model) and down_in.shape == (E, C, cfg.d_ff)
    assert torch.equal(gate_in, up_in)
    probs = torch.softmax(x.reshape(N, -1).float() @ mod.router, dim=-1)
    counts = torch.bincount(torch.topk(probs, K, dim=-1).indices.reshape(-1), minlength=E)
    empty = counts == 0
    assert 0 < int((~empty).sum()) <= N * K and int(empty.sum()) >= E - N * K
    for buf in (gate_in, down_in):
        assert buf.dtype == dtype
        assert not bool(buf[empty].ne(0).any())  # exactly zero, every row and value
        assert bool(buf[~empty].ne(0).any(dim=-1).all())  # each kept expert's row is not
