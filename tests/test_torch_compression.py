"""The port's int8 compression with error feedback against the JAX
package's, on the CPU.

``quantize_block`` runs in this process on both sides.  The compressed ring
AllReduce, ``Compressor.sync`` and the error-feedback SGD quadratic of
``tests/test_compression.py`` run once in a JAX subprocess with 8 forced
host devices and once on 8 gloo ranks of the port
(``_torch_ranks.launch``).

The port computes what the reference writes: ``max|block| / 127`` and
``acc + q * scale`` rounded after each operation, and its codes, scales and
dequantized blocks equal JAX's op-by-op results to the bit.  Under ``jit``
XLA's CPU compiler rewrites both (the division into a product with
``1/127``, the dequantize-and-add into one fused multiply-add), so the
jitted reference itself differs from its own ops in the last bit, and the
ring's outputs and residuals are held to 1e-6 of the largest input (no
int8 code differs on these inputs: a code one step off would be 1/127 of
a block's largest entry), and to the JAX test's own bar of the exact sum.
"""

import pickle
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _subproc import run_with_devices
from _torch_ranks import launch

from repro.parallel import compression as jcomp
from repro_torch.core.device_order import MeshAxis
from repro_torch.parallel.compression import (
    Compressor,
    compressed_ring_all_reduce,
    dequantize_block,
    quantize_block,
)

torch.set_num_threads(2)  # several test processes share the cores

# (stride, block, elements a rank): the JAX test's (3, 64, 300) first.
RING_CASES = [(3, 64, 300), (1, 64, 300), (5, 32, 77), (7, 1024, 1000), (3, 64, 13)]


def _inputs():
    rng = np.random.default_rng(0)
    ring = {c: rng.standard_normal((8, c[2])).astype(np.float32) for c in RING_CASES}
    grads = {"a": rng.standard_normal((8, 100)), "b": rng.standard_normal((8, 37)),
             "c": rng.standard_normal((8, 2, 50))}
    res = {k: 1e-3 * rng.standard_normal(v.shape) for k, v in grads.items()}
    target = rng.standard_normal(64).astype(np.float32)
    noise = rng.standard_normal((60, 8, 64)).astype(np.float32)
    return {"ring": ring, "sync_grads": {k: v.astype(np.float32) for k, v in grads.items()},
            "sync_res": {k: v.astype(np.float32) for k, v in res.items()},
            "target": target, "noise": noise}


_JAX = """
import pickle
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map_compat
from repro.parallel.compression import Compressor, compressed_ring_all_reduce

with open({inputs!r}, "rb") as f:
    inp = pickle.load(f)
mesh = jax.make_mesh((8,), ("x",))

def smap(fn, in_specs, out_specs):
    return jax.jit(shard_map_compat(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                    check_replication=False))

out = {{"ring": {{}}}}
for key, arr in inp["ring"].items():
    p, block, _ = key
    fn = smap(lambda v, p=p, block=block: tuple(
        r[None] for r in compressed_ring_all_reduce(v[0], "x", p=p, block=block)),
        P("x"), (P("x"), P("x")))
    y, res = fn(jnp.asarray(arr))
    out["ring"][key] = (np.asarray(y), np.asarray(res))

comp = Compressor(block=32)
def sync(g, r):
    g = {{k: v[0] for k, v in g.items()}}
    r = {{k: v[0] for k, v in r.items()}}
    gs, rs = comp.sync(g, r, "x", strides=(1, 3))
    return {{k: v[None] for k, v in gs.items()}}, {{k: v[None] for k, v in rs.items()}}
gs, rs = smap(sync, (P("x"), P("x")), (P("x"), P("x")))(
    {{k: jnp.asarray(v) for k, v in inp["sync_grads"].items()}},
    {{k: jnp.asarray(v) for k, v in inp["sync_res"].items()}})
out["sync"] = ({{k: np.asarray(v) for k, v in gs.items()}}, {{k: np.asarray(v) for k, v in rs.items()}})

target = jnp.asarray(inp["target"])
def step(w, residual, noise):
    g = (w - target) + 0.01 * noise[0]
    g_sync, new_res = comp.sync({{"w": g}}, {{"w": residual[0]}}, "x", strides=(1, 3))
    return w - 0.3 * g_sync["w"], new_res["w"][None]
step = smap(step, (P(), P("x"), P("x")), (P(), P("x")))
w, res = jnp.zeros(64, jnp.float32), jnp.zeros((8, 64), jnp.float32)
for noise in inp["noise"]:
    w, res = step(w, res, jnp.asarray(noise))
out["quadratic"] = np.asarray(w)
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("PASS")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the inputs, JAX's results, the port's by rank)."""
    tmp = tmp_path_factory.mktemp("compression")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    code = _JAX.format(inputs=str(tmp / "inputs.pkl"), path=str(tmp / "jax.pkl"))
    with ThreadPoolExecutor(1) as pool:  # JAX's subprocess runs beside the port's ranks
        jax_run = pool.submit(run_with_devices, code, 8)
        port = launch("compression", 8, tmp / "port", inputs)
        assert "PASS" in jax_run.result()
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return inputs, ref, port


def _quantize_inputs():
    rng = np.random.default_rng(3)
    cases = {f"normal-{n}-{b}": (rng.standard_normal(n).astype(np.float32), b)
             for n, b in [(5000, 256), (1, 8), (3000, 512), (1000, 1000), (77, 32)]}
    cases["zeros-64-32"] = (np.zeros(64, np.float32), 32)
    # max 127 -> scale 1: the halves round to even, as jnp.round does.
    halves = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5], np.float32)
    cases["halves-10-16"] = (halves, 16)
    return cases


@pytest.mark.parametrize("name", list(_quantize_inputs()))
def test_quantize_block_equals_jax(name):
    x, block = _quantize_inputs()[name]
    q, s, size = quantize_block(torch.from_numpy(x), block)
    jq, js, jsize = jcomp.quantize_block(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and size == jsize
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    deq = dequantize_block(q, s)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jcomp.dequantize_block(jq, js)))
    err = np.abs(deq.numpy()[: x.size] - x)
    assert err.max() <= np.abs(x).max() / 254 + 1e-7


# Of the largest input: the last bits XLA's rewrites move (see above).
ULP_BAR = 1e-6


@pytest.mark.parametrize("case", RING_CASES, ids=[f"p{p}-block{b}-n{n}" for p, b, n in RING_CASES])
def test_compressed_ring_matches_jax(results, case):
    """Outputs and residuals of every rank within ``ULP_BAR`` of JAX's, and
    the output within the JAX test's bar: 0.1 * 8 of the largest input."""
    inputs, ref, port = results
    want_y, want_res = ref["ring"][case]
    x = inputs["ring"][case]
    bar = ULP_BAR * np.abs(x).max()
    for pos, res in enumerate(port):  # the plain mesh: rank == position
        y, r = res["ring"][case]
        assert y.dtype == np.float32 and r.dtype == np.float32 and y.shape == r.shape == x[0].shape
        np.testing.assert_allclose(y, want_y[pos], rtol=0, atol=bar)
        np.testing.assert_allclose(r, want_res[pos], rtol=0, atol=bar)
        assert np.abs(y - x.sum(axis=0)).max() < 0.1 * np.abs(x).max() * 8


def test_compressor_sync_matches_jax(results):
    """Three leaves over strides (1, 3), leaf i on stride (1, 3)[i % 2] in
    sorted-name order, as ``jax.tree.flatten`` orders a dict: each rank's
    mean gradients and residuals within ``ULP_BAR`` of JAX's."""
    inputs, ref, port = results
    want_g, want_r = ref["sync"]
    for pos, res in enumerate(port):
        g, r = res["sync"]
        assert sorted(g) == sorted(want_g)
        for k in g:
            bar = ULP_BAR * np.abs(inputs["sync_grads"][k]).max() * 8
            np.testing.assert_allclose(g[k], want_g[k][pos], rtol=0, atol=bar)
            np.testing.assert_allclose(r[k], want_r[k][pos], rtol=0, atol=bar)


def test_error_feedback_sgd_reaches_the_quadratics_minimum(results):
    """60 steps of SGD on compressed gradients: every rank's w within 1e-4 of
    JAX's and within 0.05 of the minimum (the JAX test's bar)."""
    inputs, ref, port = results
    for res in port:
        np.testing.assert_allclose(res["quadratic"], ref["quadratic"], rtol=0, atol=1e-4)
        assert np.linalg.norm(res["quadratic"] - inputs["target"]) < 0.05


def test_one_rank_returns_its_input_and_a_zero_residual():
    x = torch.randn(5, 7)
    y, r = compressed_ring_all_reduce(x, MeshAxis((0,), 0), p=1, block=64)
    assert y is x and torch.equal(r, torch.zeros_like(x))
    g, res = Compressor().sync({"w": x}, {"w": torch.zeros(5, 7)}, MeshAxis((0,), 0))
    assert torch.equal(g["w"], x) and torch.equal(res["w"], torch.zeros(5, 7))
