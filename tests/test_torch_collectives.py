"""The port's TotientPerms collectives, mesh order and GPipe against the JAX
package's, on the CPU.

The JAX side runs once, in a subprocess with 8 forced host devices
(``shard_map``); the port's runs once, on 8 gloo ranks (4 for GPipe), one
process a rank (``_torch_ranks.launch``).  Every collective's result on
every mesh position equals JAX's to the bit, in float32 and int32, at
ragged sizes, on a plain mesh and on one reordered by TotientPerms stride 3
(a rank's position there is its mesh coordinate, not its rank in a group).
The plain all-reduce (``psum``, gloo's own order of additions) is held to
1e-6 of the sum; GPipe to 1e-5.
"""

import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from _subproc import run_with_devices
from _torch_ranks import (
    COLLECTIVE_CASES,
    MESH_INPUTS,
    MESH_STRIDES,
    a2a_input,
    collective_inputs,
    gpipe_inputs,
    launch,
    scatter_inputs,
)

from repro.core import device_order as jdo
from repro_torch.core import device_order
from repro_torch.core.collectives import (
    multi_ring_all_reduce,
    multi_tree_all_reduce,
    psum,
    recursive_hd_all_reduce,
    topoopt_psum_fn,
)
from repro_torch.core.device_order import MeshAxis

torch.set_num_threads(2)  # several test processes share the cores

_JAX = """
import pickle, sys
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map_compat
from repro.core import collectives as C
from repro.core.device_order import topoopt_mesh
from repro.parallel.pipeline import make_gpipe_step
sys.path.insert(0, {tests!r})
from _torch_ranks import (COLLECTIVE_CASES, MESH_INPUTS, MESH_STRIDES, a2a_input, collective_inputs,
                          gpipe_inputs, scatter_inputs)

def smap(fn, mesh, out_specs=P("x")):
    return jax.jit(shard_map_compat(fn, mesh=mesh, in_specs=P("x"), out_specs=out_specs,
                                    check_replication=False))

def case_fn(kind, strides):
    if kind == "psum":
        return lambda v: jax.lax.psum(v, "x")
    if kind == "recursive_hd":
        return lambda v: C.recursive_hd_all_reduce(v, "x")
    f = getattr(C, kind + "_all_reduce")
    return lambda v: f(v, "x", strides)

out = {{"mesh": {{}}, "cases": {{}}, "scatter": {{}}, "a2a": {{}}}}
for mesh_name, stride in MESH_STRIDES.items():
    mesh = topoopt_mesh((8,), ("x",), allreduce_axis="x", stride=stride)
    out["mesh"][mesh_name] = [d.id for d in mesh.devices.flat]
    fns = [case_fn(k, s) for k, s in COLLECTIVE_CASES]
    all_cases = smap(lambda v: tuple(f(v) for f in fns), mesh,
                     out_specs=tuple(P("x") for _ in fns))
    for in_name in MESH_INPUTS[mesh_name]:
        arr = collective_inputs()[in_name]
        for (kind, strides), y in zip(COLLECTIVE_CASES, all_cases(jnp.asarray(arr))):
            out["cases"][(mesh_name, in_name, kind, strides)] = np.asarray(y)
    rs = smap(lambda v: C.ring_reduce_scatter(v, "x", 3), mesh)
    for in_name, arr in scatter_inputs().items():
        out["scatter"][(mesh_name, in_name)] = np.asarray(rs(jnp.asarray(arr))).reshape(8, -1)
    for p in (1, 3, 5):
        a2a = smap(lambda v, p=p: C.all_to_all_ring(v[0], "x", p)[None], mesh)
        out["a2a"][(mesh_name, p)] = np.asarray(a2a(jnp.asarray(a2a_input())))

g = gpipe_inputs()
mesh4 = jax.make_mesh((4,), ("pipe",), devices=jax.devices()[:4])
step = make_gpipe_step(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), mesh4, "pipe")
params = {{"w": jnp.asarray(g["w"]), "b": jnp.asarray(g["b"])}}
out["gpipe"] = {{m: np.asarray(step(params, jnp.asarray(mbs))) for m, mbs in g["mbs"].items()}}
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("PASS")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's results, the port's by rank, the port's GPipe by rank)."""
    tmp = tmp_path_factory.mktemp("collectives")
    path = tmp / "jax.pkl"
    code = _JAX.format(tests=str(Path(__file__).parent), path=str(path))
    with ThreadPoolExecutor(1) as pool:  # JAX's subprocess runs beside the port's ranks
        jax_run = pool.submit(run_with_devices, code, 8)
        port = launch("collectives", 8, tmp / "port")
        pipe = launch("four_ranks", 4, tmp / "four")
        assert "PASS" in jax_run.result()
    with open(path, "rb") as f:
        ref = pickle.load(f)
    return ref, port, pipe


def _by_position(port, mesh_name, key, section="cases"):
    """The port's result for ``key`` stacked in mesh-position order."""
    rows = {}
    for res in port:
        _, pos = res["mesh"][mesh_name]
        rows[pos] = res[section][key]
    return np.stack([rows[p] for p in range(8)])


@pytest.mark.parametrize("mesh_name", list(MESH_STRIDES))
def test_mesh_positions_match_jax(results, mesh_name):
    """Position j of the stride-p mesh holds rank (j * p) % n on both sides,
    and each rank's reported position is where it sits."""
    ref, port, _ = results
    for rank, res in enumerate(port):
        ranks, pos = res["mesh"][mesh_name]
        assert list(ranks) == ref["mesh"][mesh_name]
        assert ranks[pos] == rank
    if mesh_name == "stride3":  # group rank (sorted) and mesh position differ here
        assert any(res["mesh"][mesh_name][1] != rank for rank, res in enumerate(port))


@pytest.mark.parametrize("mesh_name,in_name",
                         [(m, i) for m, names in MESH_INPUTS.items() for i in names])
@pytest.mark.parametrize("kind,strides", COLLECTIVE_CASES,
                         ids=[f"{k}{list(s)}" for k, s in COLLECTIVE_CASES])
def test_collective_equals_jax_to_the_bit(results, kind, strides, mesh_name, in_name):
    ref, port, _ = results
    key = (mesh_name, in_name, kind, strides)
    got = _by_position(port, mesh_name, key)[:, 0]
    want = ref["cases"][key]
    assert got.dtype == want.dtype and got.shape == want.shape
    exact = collective_inputs()[in_name].sum(axis=0, dtype=np.float64)
    if kind == "psum" and in_name.startswith("normal"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.broadcast_to(exact, got.shape), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_name", list(scatter_inputs()))
@pytest.mark.parametrize("mesh_name", list(MESH_STRIDES))
def test_reduce_scatter_owns_jax_segment(results, mesh_name, in_name):
    """Ring position j owns segment (j + 1) % n of the sum, as in JAX."""
    ref, port, _ = results
    got = _by_position(port, mesh_name, (mesh_name, in_name), "scatter")
    np.testing.assert_array_equal(got, ref["scatter"][(mesh_name, in_name)])
    full = scatter_inputs()[in_name].sum(axis=0).reshape(8, 2)
    inv = pow(3, -1, 8)
    for pos in range(8):
        np.testing.assert_allclose(got[pos], full[(pos * inv + 1) % 8], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("mesh_name", list(MESH_STRIDES))
def test_all_to_all_ring_equals_jax(results, mesh_name, p):
    ref, port, _ = results
    got = _by_position(port, mesh_name, (mesh_name, p), "a2a")
    np.testing.assert_array_equal(got, ref["a2a"][(mesh_name, p)])
    np.testing.assert_array_equal(got, np.transpose(a2a_input(), (1, 0, 2)))


@pytest.mark.parametrize("m", [1, 2, 5, 6])
def test_gpipe_matches_jax(results, m):
    """Every rank holds the last stage's outputs after the sum over stages."""
    ref, _, pipe = results
    want = ref["gpipe"][m]
    g = gpipe_inputs()
    x = g["mbs"][m]
    for s in range(4):  # the plain sequence of stages
        x = np.tanh(x @ g["w"][s] + g["b"][s])
    np.testing.assert_allclose(want, x, rtol=1e-5, atol=1e-5)
    for res in pipe:
        np.testing.assert_allclose(res[m], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["a", "b"])
def test_a_2x2_mesh_sums_over_each_axis(results, name):
    """On a 2 x 2 grid of ranks each axis is a line of 2: ``psum`` over the
    line's own process group and the ring over its global ranks give the
    line's sum of (rank + 1)."""
    _, _, four = results
    grid = np.arange(4).reshape(2, 2)
    for rank, res in enumerate(four):
        ranks, pos, by_group, by_ring = res["mesh2d"][name]
        r, c = divmod(rank, 2)
        line = grid[:, c] if name == "a" else grid[r]
        assert list(ranks) == list(line) and ranks[pos] == rank
        np.testing.assert_array_equal(by_group, np.full(3, float((line + 1).sum())))
        np.testing.assert_array_equal(by_ring, by_group)


def test_halving_doubling_refuses_a_group_of_6():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="power-of-two"):
        recursive_hd_all_reduce(x, MeshAxis(tuple(range(6)), 0))


@pytest.mark.parametrize("n", range(1, 17))
def test_permuted_axis_order_equals_jax(n):
    for p in range(1, max(n, 2)):
        if np.gcd(p, n) != 1:
            with pytest.raises(ValueError):
                device_order.permuted_axis_order(n, p)
            continue
        assert device_order.permuted_axis_order(n, p) == jdo.permuted_axis_order(n, p)
    grid = np.arange(3 * n).reshape(3, n)
    np.testing.assert_array_equal(device_order.reorder_mesh_devices(grid, 1, 1),
                                  jdo.reorder_mesh_devices(grid, 1, 1))


def test_every_collective_returns_its_input_on_one_rank():
    """At n == 1 every collective is the identity, as in JAX."""
    x = torch.arange(5.0)
    one = MeshAxis((0,), 0)
    for fn in (lambda v: multi_ring_all_reduce(v, one, (1,)), lambda v: psum(v, one),
               lambda v: multi_tree_all_reduce(v, one, (1,)),
               lambda v: recursive_hd_all_reduce(v, one)):
        assert fn(x) is x


def test_topoopt_psum_fn_picks_the_searched_schedule():
    """The selection rules of ``tests/test_schedules.py``'s
    ``test_topoopt_psum_fn_picks_searched_schedule``, on the port."""
    from repro_torch.core.schedules import schedule_strides

    ax = MeshAxis(tuple(range(8)), 0)
    assert topoopt_psum_fn((1, 3), ax).func is multi_ring_all_reduce
    assert topoopt_psum_fn((), ax).func is psum
    assert topoopt_psum_fn((1, 2, 4), ax, "recursive_hd", 8).func is recursive_hd_all_reduce
    assert topoopt_psum_fn((1, 5), ax, "recursive_hd", 6).func is multi_ring_all_reduce
    strides = schedule_strides(8, "multi_tree", 2)
    fn = topoopt_psum_fn(strides, ax, "multi_tree", 8)
    assert fn.func is multi_tree_all_reduce and fn.keywords["strides"] == strides
    assert topoopt_psum_fn((), ax, "multi_tree").func is psum
    with pytest.raises(ValueError, match="unknown collective schedule"):
        topoopt_psum_fn((1,), ax, "bogus")
    with pytest.raises(ValueError, match="at least one ring stride"):
        multi_ring_all_reduce(torch.zeros(3), ax, ())
    with pytest.raises(ValueError, match="at least one tree stride"):
        multi_tree_all_reduce(torch.zeros(3), ax, ())
    with pytest.raises(ValueError, match="not coprime"):
        multi_ring_all_reduce(torch.zeros(3), ax, (2,))
