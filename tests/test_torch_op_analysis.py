"""The port's op-by-op analyser (``repro_torch.launch.op_analysis``) against
``repro.launch.hlo_analysis.analyze_hlo`` on the same programs, and the
kernel ops on the modelled card (``meta`` tensors): their fake
implementations give the plain versions' shapes and dtypes, count a launch,
and build nothing."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
from repro_torch.kernels.moe_gmm import moe_gmm_bwd
from repro_torch.kernels.ref import (
    ref_flash_attention, ref_flash_attention_bwd, ref_flash_attention_lse, ref_mamba_scan,
    ref_mamba_scan_bwd, ref_moe_gmm, ref_moe_gmm_bwd, ref_rglru_scan, ref_rglru_scan_bwd,
)
from repro_torch.kernels.rglru_scan import rglru_scan_bwd
from repro_torch.launch import roofline
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.op_analysis import OpAnalysis, collective_type

torch.set_num_threads(2)  # several test processes share the cores

META = torch.device("meta")


def _compile(fn, *specs):
    return jax.jit(fn).lower(*specs).compile().as_text()


def _f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _counted(fn, *args):
    analysis = OpAnalysis()
    with analysis:
        fn(*args)
    return analysis.result()


def test_matmul_flops_equal_the_references():
    M, K, N = 64, 128, 256
    want = analyze_hlo(_compile(lambda x, w: x @ w, _f32(M, K), _f32(K, N)))
    got = _counted(lambda x, w: x @ w, _meta(M, K), _meta(K, N))
    assert got["flops"] == want["flops"] == 2 * M * K * N


def test_loop_flops_equal_the_references_trip_count():
    M, K, L = 32, 64, 7

    def f(x, w):
        out, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None, length=L)
        return out

    def g(x, w):
        for _ in range(L):
            x = torch.tanh(x @ w)

    want = analyze_hlo(_compile(f, _f32(M, K), _f32(K, K)))
    assert _counted(g, _meta(M, K), _meta(K, K))["flops"] == want["flops"] == L * 2 * M * K * K


def test_nested_loop_flops_equal_the_references():
    M, K = 16, 32

    def f(x, w):
        def outer(c, _):
            c2, _ = jax.lax.scan(lambda d, _: (d @ w, None), c, None, length=3)
            return c2, None
        out, _ = jax.lax.scan(outer, x, None, length=5)
        return out

    def g(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w

    want = analyze_hlo(_compile(f, _f32(M, K), _f32(K, K)))
    assert _counted(g, _meta(M, K), _meta(K, K))["flops"] == want["flops"] == 15 * 2 * M * K * K


def test_elementwise_bytes_inside_the_references_bar():
    M = 512
    want = analyze_hlo(_compile(lambda x: jnp.tanh(x) * 2.0 + 1.0, _f32(M, M)))
    got = _counted(lambda x: torch.tanh(x) * 2.0 + 1.0, _meta(M, M))
    for res in (want, got):
        assert 2 * M * M * 4 <= res["bytes"] <= 10 * M * M * 4
    assert got["flops"] == 0


def test_views_and_allocations_move_no_bytes_and_updates_move_twice_theirs():
    M = 256

    def f(buf, rows, upd):
        buf.t().reshape(-1)[:7]  # a copy: the transpose read, the copy written
        buf.reshape(-1)[:7]
        torch.empty_like(buf)
        buf[rows] = upd  # index_put_: the update read, the rows written
        buf[:4].copy_(upd)  # copy_ into a slice
        return buf[rows]  # a small gather: the rows read and written, the index read

    rows = torch.arange(4, device=META)
    upd = _meta(4, M)
    res = _counted(f, _meta(M, M), rows, upd)
    upd_b, idx_b = 4 * M * 4, 4 * 8
    assert res["bytes"] == 2 * M * M * 4 + 2 * (upd_b + idx_b) + 2 * upd_b + 2 * (upd_b + idx_b)


_SYNTHETIC_HLO = """
HloModule test

%cond (p: (s32[], f32[16])) -> pred[] {
  %p = (s32[], f32[16]) parameter(0)
  %gte = s32[] get-tuple-element(%p), index=0
  %c = s32[] constant(12)
  ROOT %lt = pred[] compare(%gte, %c), direction=LT
}

%body (p.1: (s32[], f32[16])) -> (s32[], f32[16]) {
  %p.1 = (s32[], f32[16]) parameter(0)
  %gte.1 = s32[] get-tuple-element(%p.1), index=0
  %gte.2 = f32[16] get-tuple-element(%p.1), index=1
  %one = s32[] constant(1)
  %next = s32[] add(%gte.1, %one)
  %ar = f32[16]{0} all-reduce(%gte.2), to_apply=%add_comp
  ROOT %t = (s32[], f32[16]) tuple(%next, %ar)
}

ENTRY %main (x: f32[16]) -> f32[16] {
  %x = f32[16]{0} parameter(0)
  %zero = s32[] constant(0)
  %init = (s32[], f32[16]) tuple(%zero, %x)
  %w = (s32[], f32[16]) while(%init), condition=%cond, body=%body
  %res = f32[16]{0} get-tuple-element(%w), index=1
  ROOT %ag = f32[32]{0} all-gather(%res), dimensions={0}
}
"""


@contextlib.contextmanager
def fake_group(n: int):
    made = fake_world(n)
    try:
        yield
    finally:
        if made:
            dist.destroy_process_group()


def test_collectives_equal_the_references_on_a_fake_group():
    """The synthetic program: 12 all-reduces of f32[16] in a loop, then an
    all-gather of it over 2 ranks into f32[32]."""
    def g(x):
        for _ in range(12):
            dist.all_reduce(x)
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)

    want = analyze_hlo(_SYNTHETIC_HLO)["collectives_by_type"]
    with fake_group(2):
        got = _counted(g, _meta(16))["collectives_by_type"]
    assert got == want == {"all-reduce": 12 * 2 * 64, "all-gather": 128}


def test_collective_types_by_op_name():
    names = {"c10d::allreduce_": "all-reduce", "_c10d_functional::all_reduce": "all-reduce",
             "c10d::allgather_": "all-gather",
             "_c10d_functional::all_gather_into_tensor": "all-gather",
             "c10d::_reduce_scatter_base_": "reduce-scatter",
             "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
             "c10d::alltoall_base_": "all-to-all",
             "_c10d_functional::all_to_all_single": "all-to-all",
             "c10d::send": "collective-permute", "c10d::recv_": "collective-permute",
             "_c10d_functional::wait_tensor": None, "aten::mm": None}
    assert {n: collective_type(n) for n in names} == names


def test_peak_memory_follows_the_live_storages():
    def f(x):
        y = x * 2  # 4 KB live
        z = y + 1  # 8 KB live: the peak
        del y
        return z.sum()  # 4 KB + 4 B

    analysis = OpAnalysis()
    x = _meta(1024)
    analysis.hold(x)
    with analysis:
        out = f(x)
    res = analysis.result()
    assert res["argument_bytes"] == 4096
    assert res["peak_temp_bytes"] == 8192
    assert res["peak_bytes"] == 4096 + 8192
    assert analysis.made_bytes(out) == 4


# --- the kernel ops on the modelled card ---------------------------------------


def _rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _like_on_card(*tensors, grad: bool = False):
    return [torch.empty_like(t, device=META).requires_grad_(grad) for t in tensors]


def _same_layout(got, want):
    got, want = list(got), list(want)
    assert [(tuple(g.shape), g.dtype) for g in got] == [(tuple(w.shape), w.dtype) for w in want]
    assert all(g.is_meta for g in got)


@pytest.fixture(autouse=True)
def nothing_built(monkeypatch):
    for name in [n for n in vars(ops) if n.endswith("_launches")]:
        monkeypatch.setattr(ops, name, 0)
    assert not _build._LIBS
    yield
    assert not _build._LIBS


ATTENTION = [(2, 4, 2, 16, 16, 64, True, 0), (1, 4, 1, 8, 24, 128, False, 0),
             (2, 2, 2, 16, 16, 64, True, 5)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,window", ATTENTION)
def test_attention_ops_on_the_modelled_card(dtype, B, H, KV, Sq, Sk, D, causal, window):
    rng = np.random.default_rng(0)
    q, do = _rand(rng, B, H, Sq, D, dtype=dtype), _rand(rng, B, H, Sq, D, dtype=dtype)
    k, v = _rand(rng, B, KV, Sk, D, dtype=dtype), _rand(rng, B, KV, Sk, D, dtype=dtype)
    mq, mk, mv = _like_on_card(q, k, v)
    analysis = OpAnalysis()
    with analysis:
        out = ops.attention(mq, mk, mv, causal=causal, window=window)
    _same_layout([out], [ref_flash_attention(q, k, v, causal, window)])
    assert ops.attention_launches == 1
    assert analysis.result()["flops"] == roofline.attention_flops(B, H, D, Sq, Sk, causal, window)

    o, lse = ref_flash_attention(q, k, v, causal, window), ref_flash_attention_lse(
        q, k, v, causal, window)
    want = ref_flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    _same_layout(flash_attention_bwd(*_like_on_card(q, k, v, o, lse, do), causal, window), want)

    mq, mk, mv = _like_on_card(q, k, v, grad=True)
    analysis = OpAnalysis()
    with analysis:
        ops.attention(mq, mk, mv, causal=causal, window=window).backward(
            *_like_on_card(do))
    _same_layout([mq.grad, mk.grad, mv.grad], want)
    assert (ops.attention_launches, ops.attention_bwd_launches) == (2, 1)
    assert analysis.result()["flops"] == 14.0 * B * H * D * roofline.attention_pairs(
        Sq, Sk, causal, window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E,C,D,F", [(4, 40, 64, 32), (3, 2, 16, 24)])
def test_grouped_matmul_ops_on_the_modelled_card(dtype, E, C, D, F):
    rng = np.random.default_rng(1)
    x, w, dy = (_rand(rng, E, C, D, dtype=dtype), _rand(rng, E, D, F, dtype=dtype),
                _rand(rng, E, C, F, dtype=dtype))
    out = ops.grouped_matmul(*_like_on_card(x, w))
    _same_layout([out], [ref_moe_gmm(x, w)])
    assert ops.grouped_matmul_launches == 1
    want = ref_moe_gmm_bwd(x, w, dy)
    _same_layout(moe_gmm_bwd(*_like_on_card(x, w, dy)), want)
    _same_layout(moe_gmm_bwd(*_like_on_card(x, w, dy), need_dx=False)[1:], want[1:])

    mx, mw = _like_on_card(x, w, grad=True)
    analysis = OpAnalysis()
    with analysis:
        ops.grouped_matmul(mx, mw).backward(*_like_on_card(dy))
    _same_layout([mx.grad, mw.grad], want)
    assert (ops.grouped_matmul_launches, ops.grouped_matmul_bwd_launches) == (2, 1)
    assert analysis.result()["flops"] == roofline.grouped_matmul_flops(E, C, D, F, 3)


def _scan_inputs(rng, B, L, DI, ST, dtype):
    return (_rand(rng, B, L, DI, dtype=dtype), _rand(rng, B, L, DI).abs(),
            -_rand(rng, DI, ST).abs(), _rand(rng, B, L, ST, dtype=dtype),
            _rand(rng, B, L, ST, dtype=dtype), _rand(rng, DI))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,L,DI,ST", [(2, 19, 8, 4), (1, 32, 16, 16)])
def test_selective_scan_ops_on_the_modelled_card(dtype, B, L, DI, ST):
    rng = np.random.default_rng(2)
    ins = _scan_inputs(rng, B, L, DI, ST, dtype)
    _same_layout(ops.selective_scan(*_like_on_card(*ins)), ref_mamba_scan(*ins))
    assert ops.selective_scan_launches == 1
    y, h, ckpt = ref_mamba_scan(*ins, checkpoints=True)
    _same_layout(mamba_scan(*_like_on_card(*ins), checkpoints=True), (y, h, ckpt))
    dy, dh = _rand(rng, B, L, DI), _rand(rng, B, DI, ST)
    want = ref_mamba_scan_bwd(*ins, dy, dh)
    _same_layout(mamba_scan_bwd(*_like_on_card(*ins, dy, dh, ckpt)), want)

    on_card = _like_on_card(*ins, grad=True)
    analysis = OpAnalysis()
    with analysis:
        y, h = ops.selective_scan(*on_card)
        torch.autograd.backward([y, h], _like_on_card(dy, dh))
    _same_layout([t.grad for t in on_card], want)
    assert (ops.selective_scan_launches, ops.selective_scan_bwd_launches) == (2, 1)
    assert analysis.result()["flops"] == 0  # a scan runs no product


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,L,D", [(2, 19, 33), (1, 64, 16)])
def test_lru_scan_ops_on_the_modelled_card(dtype, B, L, D):
    rng = np.random.default_rng(3)
    a, b = _rand(rng, B, L, D, dtype=dtype).sigmoid(), _rand(rng, B, L, D, dtype=dtype)
    h_all, h_fin = ref_rglru_scan(a, b)
    _same_layout(ops.lru_scan(*_like_on_card(a, b)), (h_all, h_fin))
    assert ops.lru_scan_launches == 1
    dh_all, dh_fin = _rand(rng, B, L, D), _rand(rng, B, D)
    want = ref_rglru_scan_bwd(a, h_all, dh_all, dh_fin)
    _same_layout(rglru_scan_bwd(*_like_on_card(a, h_all, dh_all, dh_fin)), want)

    ma, mb = _like_on_card(a, b, grad=True)
    analysis = OpAnalysis()
    with analysis:
        h, hf = ops.lru_scan(ma, mb)
        torch.autograd.backward([h, hf], _like_on_card(dh_all, dh_fin))
    _same_layout([ma.grad, mb.grad], want)
    assert (ops.lru_scan_launches, ops.lru_scan_bwd_launches) == (2, 1)
    assert analysis.result()["flops"] == 0  # a scan runs no product


# (B, H, KV, Sq, D, work bytes): the wgmma backward's scratch at D = 80 (4
# query tiles' turn counters in 256 bytes, then dq's fp32 sums, 4 x 64 x 80
# x 4) and at D = 256 on the modelled card's 132 SMs (8 key blocks, so the
# 16 query heads split 16 ways: 2 x 16 fp32 partials of dk and dv), none at 128.
ATTENTION_SCRATCH = [(1, 2, 2, 100, 80, 256 + 81920), (1, 16, 1, 512, 256, 16 * 2**20),
                     (1, 4, 1, 64, 128, 0)]


@pytest.mark.parametrize("B,H,KV,S,D,work", ATTENTION_SCRATCH)
def test_attention_bwd_scratch_counts_on_the_modelled_card(B, H, KV, S, D, work):
    q = torch.empty(B, H, S, D, dtype=torch.bfloat16, device=META)
    k = torch.empty(B, KV, S, D, dtype=torch.bfloat16, device=META)
    lse = torch.empty(B, H, S, device=META)
    analysis = OpAnalysis()
    with analysis:
        flash_attention_bwd(q, k, k, q, lse, q)
    grads = q.nbytes + 2 * k.nbytes  # dq, dk, dv
    assert analysis.result()["peak_temp_bytes"] == grads + lse.nbytes + work  # delta: lse's size


def test_selective_scan_bwd_scratch_counts_on_the_modelled_card():
    # B 2, L 19, DI 8, ST 4: one group of channels, so the db and dc partials
    # are 2 x 19 x 4 fp32 each (608 bytes, 768 aligned), dA's 2 x 8 x 4 and
    # dD's 2 x 8 (256 bytes aligned each).
    rng = np.random.default_rng(4)
    ins = _scan_inputs(rng, 2, 19, 8, 4, torch.float32)
    ckpt = ref_mamba_scan(*ins, checkpoints=True)[2]
    args = _like_on_card(*ins, _rand(rng, 2, 19, 8), ckpt)
    analysis = OpAnalysis()
    with analysis:
        grads = mamba_scan_bwd(*args[:7], None, args[7])
    work = 2 * 768 + 256 + 256
    assert analysis.result()["peak_temp_bytes"] == sum(g.nbytes for g in grads) + work
