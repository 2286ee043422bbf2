"""The port's §6 data-parallel trainer against the JAX package's
``make_shardmap_dp_train_step``, on the CPU.

The JAX side runs once in a subprocess with 8 forced host devices; the
port's on 8 gloo ranks (``_torch_ranks.launch``), from the same weights
(``weights.params_from_jax``) on the same global batches: granite-8b's
smoke config in fp32, sequence 32, global batch 8, on a mesh reordered by
the primary stride of ``topology_finder(data_parallel_demand(8, 1e9), 3)``,
3 AdamW steps for each collective schedule and for the compressed ring.
The port syncs the reference's stacked leaves, so every schedule sees the
reference's segments, block scales and order of additions.  Losses are held
at rtol 1e-5.  Parameters are held as ``tests/test_torch_train.py`` holds
three AdamW steps, 1e-4 of each leaf's largest entry, on all but 1 in 1000
entries of a leaf; AdamW's update is lr * m / (sqrt(v) + eps), about lr
times the sign of the gradient, so where the mean of the 8 ranks' gradients
cancels to near 0 the last-bit differences of the local gradients move it
by up to 2 lr a step, and those entries are held to that: 3 steps * 2 lr.
(The plain single-device step shows the same at one row of 32 tokens, the
batch each rank sees here: 4.2e-4 of a leaf's largest entry after 3 steps.)
The compressed ring is held to the same 3 steps * 2 lr on all but 1 in 100
entries of a leaf: a last-bit difference (of the local gradients, or of
the jitted reference's fused dequantize-and-add) moves an int8 code by a
step where a value sits at a rounding boundary, a step of 1/127 of its
block's largest entry, which error feedback carries into the next steps.
``test_one_ulp_moves_the_compressed_ring_past_the_plain_bar`` shows the
port's own run doing so when each local gradient moves by one ulp.
At world size 1 the DP step equals ``make_train_step``'s to the bit.
"""

import dataclasses
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from _subproc import run_with_devices
from _torch_ranks import launch

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.core import topology_finder
from repro_torch.core.demand import data_parallel_demand
from repro_torch.core.device_order import topoopt_mesh
from repro_torch.data.pipeline import DataSpec, batch_for_step
from repro_torch.models import lm
from repro_torch.optim import adamw, wsd
from repro_torch.parallel.compression import Compressor
from repro_torch.train.steps import (
    init_compressor_residual,
    make_shardmap_dp_train_step,
    make_train_step,
)
from repro_torch.weights import jax_leaf_groups, params_from_jax

torch.set_num_threads(2)  # several test processes share the cores

VARIANTS = ("ring", "recursive_hd", "multi_tree", "compressed")
LR = 1e-3  # wsd(LR, 10): the full rate from step 0
LOSS_RTOL = 1e-5
# The share of a leaf's entries allowed beyond 1e-4 of its largest entry.
BEYOND = {"ring": 1e-3, "recursive_hd": 1e-3, "multi_tree": 1e-3, "compressed": 1e-2}

_JAX = """
import dataclasses, pickle
import jax, numpy as np
import jax.numpy as jnp
from repro.configs.base import ShapeSpec, get_config
from repro.core.device_order import topoopt_mesh
from repro.data.pipeline import DataSpec, batch_for_step
from repro.optim import adamw, wsd
from repro.parallel.compression import Compressor
from repro.train.steps import init_compressor_residual, make_shardmap_dp_train_step

with open({inputs!r}, "rb") as f:
    inp = pickle.load(f)
cfg = dataclasses.replace(get_config("granite-8b").smoke(), param_dtype="float32",
                          activation_dtype="float32")
strides = tuple(inp["strides"])
mesh = topoopt_mesh((8,), ("data",), allreduce_axis="data", stride=strides[0])
init = jax.tree.map(jnp.asarray, inp["params"])
spec = DataSpec(cfg=cfg, shape=ShapeSpec("dp", 32, 8, "train"), seed=0)
out = {{"mesh": [d.id for d in mesh.devices.flat]}}
for variant in {variants!r}:
    opt = adamw(wsd({lr!r}, 10))
    comp = Compressor() if variant == "compressed" else None
    step = make_shardmap_dp_train_step(cfg, opt, mesh, "data", ring_strides=strides,
                                       compressor=comp,
                                       schedule="ring" if comp else variant)
    params, state = init, opt.init(init)
    residual = init_compressor_residual(comp, params, mesh) if comp else 0
    losses = []
    for s in range(3):
        batch = {{k: jnp.asarray(v) for k, v in batch_for_step(spec, s).items()}}
        params, state, loss, residual = step(params, state, batch, jnp.int32(s), residual)
        losses.append(float(loss))
    out[variant] = (losses, jax.tree.map(np.asarray, params))
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("PASS")
"""


def _cfg():
    return dataclasses.replace(get_config("granite-8b").smoke(), param_dtype="float32",
                               activation_dtype="float32")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the inputs, JAX's results, the port's by rank).  The weights (JAX's
    init) and the strides (the JAX package's planner) are made here; two
    JAX subprocesses, two variants each, run beside the port's ranks."""
    from repro.core import topology_finder as jtopology_finder
    from repro.core.demand import data_parallel_demand as jdemand

    tmp = tmp_path_factory.mktemp("dp_train")
    jcfg = dataclasses.replace(jget_config("granite-8b").smoke(), param_dtype="float32",
                               activation_dtype="float32")
    inputs = {"params": jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg)),
              "strides": tuple(jtopology_finder(jdemand(8, 1e9), 3).ring_strides(tuple(range(8))))}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    halves = (VARIANTS[:2], VARIANTS[2:])
    codes = [_JAX.format(inputs=str(tmp / "inputs.pkl"), variants=v, lr=LR,
                         path=str(tmp / f"jax{i}.pkl")) for i, v in enumerate(halves)]
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(run_with_devices, code, 8) for code in codes]
        port = launch("dp_train", 8, tmp / "port", inputs)
        assert all("PASS" in r.result() for r in runs)
    ref = {}
    for i in range(2):
        with open(tmp / f"jax{i}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    return inputs, ref, port


def test_the_plan_and_the_mesh_are_jaxs(results):
    """The port's planner gives the same strides, and rank r sits at the mesh
    position the JAX mesh gives device r."""
    inputs, ref, port = results
    strides = topology_finder(data_parallel_demand(8, 1e9), 3).ring_strides(tuple(range(8)))
    assert tuple(strides) == inputs["strides"] and len(strides) >= 1
    for rank, res in enumerate(port):
        assert ref["mesh"][res["pos"]] == rank


@pytest.mark.parametrize("variant", VARIANTS)
def test_losses_match_jax(results, variant):
    _, ref, port = results
    want, _ = ref[variant]
    for res in port:
        np.testing.assert_allclose(res[variant][0], want, rtol=LOSS_RTOL)
    assert all(np.isfinite(want))


def _beyond(got: dict, want: dict, variant: str) -> dict:
    """Each leaf's share of entries beyond 1e-4 of its largest entry, after
    checking that none is beyond 3 steps * 2 lr."""
    share = {}
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        share[name] = float((diff > 1e-4 * float(np.abs(w).max())).mean())
        assert diff.max() <= 3 * 2 * LR, (variant, name, float(diff.max()))
    return share


@pytest.mark.parametrize("variant", VARIANTS)
def test_parameters_match_jax(results, variant):
    _, ref, port = results
    expect = {k: v.numpy() for k, v in params_from_jax(ref[variant][1], _cfg()).items()}
    got = port[0][variant][1]
    assert sorted(got) == sorted(expect)
    for name, share in _beyond(got, expect, variant).items():
        assert share <= BEYOND[variant], (variant, name, share)


def test_one_ulp_moves_the_compressed_ring_past_the_plain_bar(results):
    """The port's compressed ring against itself with each local gradient
    entry moved by up to one ulp: some leaf moves past the uncompressed
    schedules' 1 in 1000, and every leaf stays within the compressed bar."""
    _, _, port = results
    share = _beyond(port[0]["compressed_ulp"][1], port[0]["compressed"][1], "compressed")
    assert max(share.values()) > BEYOND["ring"]
    assert max(share.values()) <= BEYOND["compressed"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_rank_holds_the_same_replica(results, variant):
    _, _, port = results
    losses, params = port[0][variant]
    for res in port[1:]:
        assert res[variant][0] == losses
        for name, p in params.items():
            np.testing.assert_array_equal(res[variant][1][name], p)


@pytest.mark.parametrize("variant", VARIANTS)
def test_world_size_one_equals_the_single_device_step_to_the_bit(variant):
    """A sync over one rank is the identity and /1 is exact, so two DP steps
    give make_train_step's losses and parameters bit for bit."""
    cfg = _cfg()
    spec = DataSpec(cfg=cfg, shape=ShapeSpec("t", 32, 4, "train"), seed=0)

    def run(dp):
        model = lm.init(0, cfg, device="cpu")
        opt = adamw(wsd(LR, 10))
        state = opt.init(dict(model.named_parameters()))
        comp = Compressor() if variant == "compressed" else None
        if dp:
            step = make_shardmap_dp_train_step(
                cfg, opt, topoopt_mesh((1,), ("data",)), ring_strides=(1,),
                compressor=comp, schedule="ring" if comp else variant)
        else:
            step = make_train_step(cfg, opt)
        residual = init_compressor_residual(comp, model) if comp else None
        losses = []
        for s in range(2):
            batch = {k: torch.from_numpy(v) for k, v in batch_for_step(spec, s).items()}
            if dp:
                _, _, loss, residual = step(model, state, batch, s, residual)
            else:
                loss = step(model, state, batch, s)[2]["loss"]
            losses.append(loss)
        return losses, dict(model.named_parameters())

    (want_l, want_p), (got_l, got_p) = run(False), run(True)
    assert all(torch.equal(a, b) for a, b in zip(got_l, want_l))
    assert all(torch.equal(got_p[n], want_p[n]) for n in want_p)


def test_a_global_batch_that_does_not_split_raises():
    cfg = _cfg()
    model = lm.init(0, cfg, device="cpu")
    mesh = topoopt_mesh((1,), ("data",))
    mesh.shape["data"] = 3  # as a 3-rank axis would see a batch of 4
    step = make_shardmap_dp_train_step(cfg, adamw(wsd(LR, 10)), mesh, schedule="multi_tree")
    with pytest.raises(ValueError, match="do not split"):
        step(model, None, {"tokens": torch.zeros(4, 8, dtype=torch.int32)}, 0)


@pytest.mark.parametrize("arch", ["granite-8b", "minicpm-2b", "qwen3-moe-30b-a3b",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "llama-3.2-vision-11b", "hubert-xlarge"])
def test_leaf_index_is_jaxs_tree_flatten_order(arch):
    """The step syncs the reference's leaves in ``jax.tree.flatten`` order
    (``Compressor.sync`` gives leaf i of the sorted key paths stride i), and
    each group, stacked, is the reference's leaf element for element, so a
    sync sees the reference's segments and block scales."""
    jcfg = dataclasses.replace(jget_config(arch).smoke(), param_dtype="float32")
    specs = jax.tree_util.tree_flatten_with_path(jlm.param_specs(jcfg))[0]
    paths = [tuple(k.key for k in p) for p, _ in specs]
    # Every entry of the reference's tree a distinct value, exact in fp32.
    sizes = np.cumsum([0] + [int(np.prod(s.shape)) for _, s in specs])
    leaves = [np.arange(a, b, dtype=np.float32).reshape(s.shape)
              for (_, s), a, b in zip(specs, sizes, sizes[1:])]
    jparams = jax.tree.unflatten(jax.tree.structure(jlm.param_specs(jcfg)), leaves)
    cfg = dataclasses.replace(get_config(arch).smoke(), param_dtype="float32")
    sd = params_from_jax(jparams, cfg)
    groups = jax_leaf_groups(cfg, list(sd))
    assert sorted(groups) == paths
    for path, leaf in zip(paths, leaves):
        np.testing.assert_array_equal(torch.stack([sd[n] for n in groups[path]]).numpy().reshape(-1),
                                      leaf.reshape(-1), err_msg=str(path))
