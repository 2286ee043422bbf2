"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
JAX package's, entry for entry, in process.

The reference's spec trees are built on ``jax.sharding.AbstractMesh`` and
the port's on a stand-in with the two attributes its rules read
(``axis_names`` and ``shape``), for every LM config at its smoke and its
full width, on the (2, 4), (16, 16) and (2, 16, 16) meshes.  The reference
stacks layers along leading dims where the port keeps one parameter a
layer, so a reference spec is the port's with the stacking dims' ``None``s
in front; the port's parameter ``n`` is compared with the reference's leaf
``weights.jax_leaf_path(n)``.
"""

import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.optim import adamw as jadamw, constant as jconstant
from repro.parallel import sharding as jsh
from repro_torch.configs import base as tbase
from repro_torch.models import lm
from repro_torch.optim import adamw, constant
from repro_torch.parallel import act_sharding, sharding
from repro_torch.train.steps import activation_policy, install_activation_policy, shapes_of
from repro_torch.weights import jax_leaf_groups, jax_leaf_path

torch.set_num_threads(2)  # several test processes share the cores

ARCHS = [n for n, c in jbase.all_configs().items() if c.family != "recsys"]
MESHES = {"2x4": ((2, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PARAM_PLANS = (dict(fsdp=True), dict(fsdp=False))
OPT_PLANS = (dict(fsdp=True), dict(fsdp=False), dict(fsdp=False, zero1=True),
             dict(fsdp=True, zero1=True))
BATCH_PLANS = (dict(), dict(seq_parallel=True))


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _configs(arch, size):
    jcfg, cfg = jbase.get_config(arch), tbase.get_config(arch)
    return (jcfg.smoke(), cfg.smoke()) if size == "smoke" else (jcfg, cfg)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _spec(x) -> tuple:
    """A reference spec (or a NamedSharding's) as the port's plain tuple."""
    spec = x.spec if isinstance(x, NamedSharding) else x
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def _check_stacked(ref_spec, ref_shape, port_spec, port_shape, where):
    ref = _spec(ref_spec)
    ref = ref + (None,) * (len(ref_shape) - len(ref))
    extra = len(ref_shape) - len(port_shape)
    assert extra >= 0, where
    assert ref[:extra] == (None,) * extra and ref[extra:] == port_spec, (where, ref, port_spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_tree_matches_jax(arch):
    for size in ("smoke", "full"):
        jcfg, cfg = _configs(arch, size)
        jspecs, specs = jlm.param_specs(jcfg), lm.param_specs(cfg)
        for mesh_name in MESHES:
            jmesh, mesh = _meshes(mesh_name)
            for kw in PARAM_PLANS:
                ref = jsh.param_spec_tree(jspecs, jsh.ShardingPlan(**kw), jmesh)
                got = sharding.param_spec_tree(specs, sharding.ShardingPlan(**kw), mesh)
                assert sorted(got) == sorted(specs)
                for name, (shape, _) in specs.items():
                    path = jax_leaf_path(name, cfg)
                    _check_stacked(_leaf(ref, path), _leaf(jspecs, path).shape, got[name],
                                   shape, (size, mesh_name, kw, name))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
def test_dlrm_param_spec_tree_matches_jax(mesh_name, fsdp):
    """DLRM (the family ARCHS leaves out): its default config's ``tables``
    (T, R, E) under the rule (None, "model", None), R = 1000 split over a
    model axis of 4 and left whole over 16, and its MLPs' weights, which no
    rule names, replicated; each port parameter against the reference's
    leaf, fsdp on and off."""
    from repro.models import dlrm as jdlrm
    from repro_torch.models import dlrm

    jspecs = jax.eval_shape(lambda: jdlrm.init(jax.random.PRNGKey(0), jdlrm.DLRMConfig()))
    model = dlrm.init(0, dlrm.DLRMConfig(), device="cpu")
    specs = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    jmesh, mesh = _meshes(mesh_name)
    ref = jsh.param_spec_tree(jspecs, jsh.ShardingPlan(fsdp=fsdp), jmesh)
    got = sharding.param_spec_tree(specs, sharding.ShardingPlan(fsdp=fsdp), mesh)
    assert sorted(got) == sorted(specs)
    for name, (shape, _) in specs.items():
        path = [int(k) if k.isdigit() else k for k in name.split(".")]
        assert _leaf(jspecs, path).shape == shape, name
        _check_stacked(_leaf(ref, path), shape, got[name], shape, (mesh_name, fsdp, name))
    split = 1000 % mesh.shape["model"] == 0
    assert got["tables"] == (None, "model" if split else None, None)
    assert all(spec == (None,) * len(spec) for n, spec in got.items() if n != "tables")


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_sharding_matches_jax(arch):
    """m, v and master, with ZeRO-1 off and on."""
    for size in ("smoke", "full"):
        jcfg, cfg = _configs(arch, size)
        jspecs, specs = jlm.param_specs(jcfg), lm.param_specs(cfg)
        jo = jax.eval_shape(jadamw(jconstant(1e-3)).init, jspecs)
        o = shapes_of(adamw(constant(1e-3)).init(
            {n: torch.empty(s, dtype=dt, device="meta") for n, (s, dt) in specs.items()}))
        assert sorted(o) == sorted(jo) == ["m", "master", "v"]
        for mesh_name in MESHES:
            jmesh, mesh = _meshes(mesh_name)
            for kw in OPT_PLANS:
                ref = jsh.opt_state_sharding(jo, jsh.ShardingPlan(**kw), jmesh)
                got = sharding.opt_state_sharding(o, sharding.ShardingPlan(**kw), mesh)
                for kind, tree in o.items():
                    for name, (shape, _) in tree.items():
                        path = (kind, *jax_leaf_path(name, cfg))
                        _check_stacked(_leaf(ref, path), _leaf(jo, path).shape, got[kind][name],
                                       shape, (size, mesh_name, kw, kind, name))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_spec_tree_matches_jax(arch):
    """TRAIN_4K's and DECODE_32K's inputs (decode caches included), without
    and with sequence parallelism; the batch and its caches are global on
    both sides, so the trees match entry for entry."""
    jcfg, cfg = jbase.get_config(arch), tbase.get_config(arch)
    n = 0
    for jshape, shape in ((jbase.TRAIN_4K, tbase.TRAIN_4K), (jbase.DECODE_32K, tbase.DECODE_32K)):
        if not jbase.shape_applicability(jcfg, jshape)[0]:
            continue
        jin, tin = jbase.input_specs(jcfg, jshape), tbase.input_specs(cfg, shape)
        for mesh_name in MESHES:
            jmesh, mesh = _meshes(mesh_name)
            for kw in BATCH_PLANS:
                ref = jsh.batch_spec_tree(jin, jcfg, jsh.ShardingPlan(**kw), jmesh)
                got = sharding.batch_spec_tree(tin, cfg, sharding.ShardingPlan(**kw), mesh)
                flat = jax.tree_util.tree_flatten_with_path(
                    ref, is_leaf=lambda x: isinstance(x, P))[0]
                assert len(flat) == len(jax.tree.leaves(jin))
                for path, spec in flat:
                    assert _leaf(got, [k.key for k in path]) == _spec(spec), (mesh_name, kw, path)
                    n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jaxs_shapes_and_dtypes(arch):
    """``lm.param_specs`` (built on the meta device, nothing drawn) against
    the reference's: each reference leaf is its group of the port's
    parameters stacked, at the smoke and the full width."""
    for size in ("smoke", "full"):
        jcfg, cfg = _configs(arch, size)
        jspecs, specs = jlm.param_specs(jcfg), lm.param_specs(cfg)
        groups = jax_leaf_groups(cfg, list(specs))
        jflat = jax.tree_util.tree_flatten_with_path(jspecs)[0]
        assert sorted(groups) == sorted(tuple(k.key for k in p) for p, _ in jflat)
        for path, leaf in jflat:
            names = groups[tuple(k.key for k in path)]
            shapes = {specs[n][0] for n in names}
            dtypes = {str(specs[n][1]).removeprefix("torch.") for n in names}
            assert len(shapes) == 1 and dtypes == {str(leaf.dtype)}, (size, path)
            shape = shapes.pop()
            extra = len(leaf.shape) - len(shape)
            assert leaf.shape[extra:] == shape, (size, path)
            assert math.prod(leaf.shape[:extra]) == len(names), (size, path)


def test_param_specs_allocate_nothing():
    specs = lm.param_specs(tbase.get_config("qwen3-moe-235b-a22b"))
    assert sum(math.prod(s) for s, _ in specs.values()) > 2e11
    assert all(isinstance(s, tuple) and isinstance(dt, torch.dtype) for s, dt in specs.values())


@pytest.mark.parametrize("spec,shape,want", [
    # 122753 is prime (minicpm vocab): the model axis is dropped.
    (("model", "data"), (122753, 64), (None, "data")),
    ((("data", "model"), None), (16, 7), (("data", "model"), None)),
    ((("data", "model"), None), (12, 7), (None, None)),
])
def test_sanitize_drops_indivisible(spec, shape, want):
    jmesh, mesh = _meshes("2x4")
    assert sharding.sanitize(spec, shape, mesh) == want
    assert _spec(jsh.sanitize(P(*spec), shape, jmesh)) == want


@pytest.mark.parametrize("mesh_name,spec,want", [
    ("2x16x16", (("pod", "data"), "model"), (Shard(0), Shard(0), Shard(1))),
    ("2x16x16", (None, ("pod", "data"), None), (Shard(1), Shard(1), Replicate())),
    ("2x16x16", ("model", None), (Replicate(), Replicate(), Shard(0))),
    ("2x4", (None, "data"), (Shard(1), Replicate())),
    ("2x4", ("model", "data"), (Shard(1), Shard(0))),
    ("2x4", (None, None), (Replicate(), Replicate())),
    ("2x4", (), (Replicate(), Replicate())),
])
def test_placements(mesh_name, spec, want):
    """One placement a mesh dim; a dim over a tuple of axes is Shard on each,
    which DTensor applies in mesh order: pod major, as P(("pod", "data"))."""
    _, mesh = _meshes(mesh_name)
    assert sharding.placements(spec, mesh) == want
    # A DeviceMesh names its axes mesh_dim_names.
    assert sharding.placements(spec, SimpleNamespace(mesh_dim_names=mesh.axis_names)) == want


def test_placements_refuse_a_tuple_against_the_mesh_order():
    _, mesh = _meshes("2x16x16")
    with pytest.raises(ValueError, match="axis order"):
        sharding.placements((("data", "pod"), None), mesh)


def test_activation_policy_leaves_plain_tensors_alone():
    """Outside a mesh ``constrain`` is the identity, as in the reference, and
    the MoE's ``gather_batch`` keeps every row; with a policy over a data
    axis of one rank, too."""
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert act_sharding.get_policy() is None
    for kind in ("btd", "bd", "btf", "ecd", "nd", "other"):
        assert act_sharding.constrain(x, kind) is x
    assert act_sharding.gather_batch(x) == (x, slice(None))
    _, mesh = _meshes("2x4")
    mesh.shape = {"data": 1, "model": 4}
    policy = act_sharding.ActivationPolicy(dp="data", tp="model", mesh=mesh)
    with act_sharding.using_policy(policy):
        assert act_sharding.get_policy() is policy
        assert act_sharding.constrain(x, "btd") is x
        got, rows = act_sharding.gather_batch(x)
        assert got is x and np.array_equal(got[rows].numpy(), x.numpy())
    assert act_sharding.get_policy() is None


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_only_install_activation_policy_leaves_a_policy_behind(mesh_name):
    """``activation_policy`` builds the plan's policy (batch over the data
    axes, sequence over ``"model"`` under seq-parallel, and how a placed
    model of the config reads each parameter) and installs nothing, which is
    what the step builder uses; ``install_activation_policy`` installs it for
    the whole process, as the reference's does."""
    _, mesh = _meshes(mesh_name)
    cfg = tbase.get_config("granite-8b")
    plan = sharding.ShardingPlan(seq_parallel=True)
    policy = activation_policy(plan, mesh, cfg)
    assert act_sharding.get_policy() is None
    assert (policy.dp, policy.tp, policy.seq) == (plan.dp_axes(mesh), "model", "model")
    assert policy.dp == (("pod", "data") if "pod" in mesh.axis_names else "data")
    assert policy.reads == sharding.model_reads(cfg, lm.param_specs(cfg), plan, mesh)
    assert sorted(policy.reads) == sorted(lm.param_specs(cfg))
    try:
        assert install_activation_policy(plan, mesh, cfg) == policy
        assert act_sharding.get_policy() == policy
    finally:
        act_sharding.set_policy(None)


def test_a_policy_without_reads_refuses_to_say_how_a_weight_reads():
    """Over a model axis of more than one rank every weight's read comes from
    the policy (``activation_policy`` fills one for every parameter): a
    policy built without them raises, not read every weight whole."""
    _, mesh = _meshes("2x4")
    policy = act_sharding.ActivationPolicy(dp="data", tp="model", seq="model", mesh=mesh)
    with act_sharding.using_policy(policy), pytest.raises(KeyError, match="no read"):
        act_sharding.read_of("blocks.0.norm")
    assert act_sharding.read_of("blocks.0.norm") == sharding.WHOLE  # no policy


@pytest.mark.parametrize("shape,axis,stride", [((8,), 0, 3), ((4, 2), 0, 3), ((2, 8), 1, 5),
                                               ((2, 4, 2), 1, 3)])
def test_device_mesh_grid_keeps_the_lines_in_rank_order(shape, axis, stride):
    """DTensor gathers a mesh dim in its process group's (rank) order, so the
    DeviceMesh takes a TopoOpt-reordered grid with each axis ascending: the
    same lines, as sets, along every axis."""
    from repro_torch.core.device_order import reorder_mesh_devices

    grid = reorder_mesh_devices(np.arange(math.prod(shape)).reshape(shape), axis, stride)
    assert not np.array_equal(grid, np.arange(grid.size).reshape(shape))
    got = sharding.ascending_grid(grid)
    np.testing.assert_array_equal(got, np.arange(grid.size).reshape(shape))
    for a in range(len(shape)):
        lines = {frozenset(x) for x in np.moveaxis(grid, a, -1).reshape(-1, shape[a]).tolist()}
        assert lines == {frozenset(x) for x in np.moveaxis(got, a, -1).reshape(-1, shape[a]).tolist()}


def test_device_mesh_grid_refuses_lines_permuted_differently():
    with pytest.raises(ValueError, match="not one permutation"):
        sharding.ascending_grid(np.array([[0, 1], [3, 2]]))
