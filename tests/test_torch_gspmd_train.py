"""The port's GSPMD/FSDP trainer (``train.steps.jit_train_step``) against the
JAX package's ``jit_train_step``, on the CPU.

The JAX side runs in two subprocesses with 8 forced host devices, each a
(2, 4) ("data", "model") mesh; the port's on 8 gloo ranks
(``_torch_ranks.launch``) on the port's mesh of the same shape, from the
same weights (``weights.params_from_jax``) and the same global batches
(sequence 32, global batch 8): granite-8b's smoke config under fsdp, no
fsdp, ZeRO-1 (parameters replicated, moments sharded) and sequence
parallelism, qwen3-moe-30b-a3b's at capacity 1.0, whose capacity and drops
are the global batch's, with and without sequence parallelism,
falcon-mamba-7b's, recurrentgemma-9b's, llama-3.2-vision-11b's (its cross
gates at 0.5 on both sides), hubert-xlarge's, minicpm-2b's (its tied head
split by vocabulary through the chunked loss, with and without sequence
parallelism) and granite-8b's with heads, vocabulary and MLP columns that
do not divide the model axis (with and without sequence parallelism), all
in fp32, 3 AdamW steps each.  GSPMD computes the single-device function of the global batch; the
port computes each data rank's rows, each model rank its own heads, MLP
columns, experts, channels and vocabulary rows (``tests/test_torch_tp_compute.py``
shows the split), and reduces, so the two differ in the order of additions
only.  Losses and grad norms are held at rtol 1e-5.
Parameters are held as ``tests/test_torch_dp_train.py`` holds them, and for
its reason: 1e-4 of each leaf's largest entry on all but 1 in 1000 entries
of a leaf; AdamW's update is lr * m / (sqrt(v) + eps), about lr times the
sign of the gradient, so where a gradient entry cancels to near 0 the last
bits of the sums move it by up to 2 lr a step, and every entry is held to
3 steps * 2 lr.  At world size 1 the step equals ``make_train_step`` to the
bit, for all six LM families.
"""

import dataclasses
import pickle
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _subproc import run_with_devices
from _torch_ranks import (
    GSPMD_BATCH, GSPMD_CONFIGS, GSPMD_GATE, GSPMD_LR, GSPMD_SEQ, GSPMD_STEPS, GSPMD_VARIANTS,
    gspmd_config, launch,
)

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.base import get_config as tbase_config
from repro_torch.core.device_order import Mesh
from repro_torch.data.pipeline import DataSpec, batch_for_step
from repro_torch.models import lm
from repro_torch.optim import adamw, wsd
from repro_torch.parallel import act_sharding
from repro_torch.parallel.sharding import (
    ShardingPlan, opt_state_sharding, param_spec_tree, parameters, placer,
)
from repro_torch.train.steps import init_opt_state, jit_train_step, make_train_step
from repro_torch.weights import params_from_jax

torch.set_num_threads(2)  # several test processes share the cores

LOSS_RTOL = 1e-5
BEYOND = 1e-3  # the share of a leaf's entries allowed beyond 1e-4 of its largest entry
MESH = {"data": 2, "model": 4}
JAX_RUNS = 2  # JAX subprocesses beside the port's ranks

_JAX = """
import dataclasses, pickle
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import ShapeSpec, get_config
from repro.data.pipeline import DataSpec, batch_for_step
from repro.optim import adamw, wsd
from repro.parallel.sharding import ShardingPlan
from repro.train.steps import jit_train_step

with open({inputs!r}, "rb") as f:
    inp = pickle.load(f)
# jax.make_mesh's explicit axes would reject the reference's gathers.
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
out = {{}}
for name in {variants!r}:
    key, kw = inp["variants"][name]
    arch, over = inp["configs"][key]
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    opt = adamw(wsd({lr!r}, 10))
    step, (_, _, p_sh, o_sh, _) = jit_train_step(cfg, opt, ShardingPlan(**kw), mesh,
                                                 donate=False)
    params = jax.device_put(jax.tree.map(jnp.asarray, inp["params"][key]), p_sh)
    state = jax.device_put(opt.init(params), o_sh)
    spec = DataSpec(cfg=cfg, shape=ShapeSpec("gspmd", {seq!r}, {batch!r}, "train"))
    losses, norms = [], []
    for s in range({steps!r}):
        batch = {{k: jnp.asarray(v) for k, v in batch_for_step(spec, s).items()}}
        with mesh:
            params, state, m = step(params, state, batch, jnp.int32(s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[name] = (losses, norms, jax.tree.map(np.asarray, params))
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("PASS")
"""


def _jcfg(name):
    arch, over = GSPMD_CONFIGS[name]
    return dataclasses.replace(jget_config(arch).smoke(), **over)


def _jparams(name):
    """The JAX package's weights of config ``name`` from seed 0 as numpy, a
    VLM's cross gates set to GSPMD_GATE."""
    params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), _jcfg(name)))
    if _jcfg(name).family == "vlm":
        attn = params["blocks"]["cross"]["attn"]
        attn["gate"] = np.full_like(attn["gate"], GSPMD_GATE)
    return params


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's results by variant, the port's by rank).  JAX_RUNS subprocesses,
    a share of the variants each, run beside the port's 8 ranks."""
    tmp = tmp_path_factory.mktemp("gspmd_train")
    inputs = {"params": {a: _jparams(a) for a in GSPMD_CONFIGS},
              "configs": GSPMD_CONFIGS, "variants": GSPMD_VARIANTS}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    names = list(GSPMD_VARIANTS)
    shares = [names[i::JAX_RUNS] for i in range(JAX_RUNS)]
    codes = [_JAX.format(inputs=str(tmp / "inputs.pkl"), variants=v, lr=GSPMD_LR,
                         seq=GSPMD_SEQ, batch=GSPMD_BATCH, steps=GSPMD_STEPS,
                         path=str(tmp / f"jax{i}.pkl")) for i, v in enumerate(shares)]
    with ThreadPoolExecutor(JAX_RUNS) as pool:
        runs = [pool.submit(run_with_devices, code, 8) for code in codes]
        port = launch("gspmd_train", 8, tmp / "port",
                      dict(inputs, variants=names + ["moe_local", "reordered"]))
        assert all("PASS" in r.result() for r in runs)
    ref = {}
    for i in range(JAX_RUNS):
        with open(tmp / f"jax{i}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    return ref, port


@pytest.mark.parametrize("variant", list(GSPMD_VARIANTS) + ["reordered"])
def test_losses_and_grad_norms_match_jax(results, variant):
    """(``reordered``: a (4, 2) mesh whose data axis takes stride 3, against
    JAX's fsdp run.)"""
    ref, port = results
    want_losses, want_norms, _ = ref["fsdp" if variant == "reordered" else variant]
    assert all(np.isfinite(want_losses)) and all(np.isfinite(want_norms))
    for res in port:
        np.testing.assert_allclose(res[variant]["losses"], want_losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(res[variant]["grad_norms"], want_norms, rtol=LOSS_RTOL)


@pytest.mark.parametrize("variant", list(GSPMD_VARIANTS) + ["reordered"])
def test_parameters_match_jax(results, variant):
    """(``reordered`` against JAX's fsdp run: GSPMD computes the same global
    function on any mesh.)"""
    ref, port = results
    want_of = "fsdp" if variant == "reordered" else variant
    key = GSPMD_VARIANTS[want_of][0]
    want = {k: v.numpy() for k, v in params_from_jax(ref[want_of][2], gspmd_config(key)).items()}
    got = port[0][variant]["params"]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= GSPMD_STEPS * 2 * GSPMD_LR, (variant, name, float(diff.max()))
        share = float((diff > 1e-4 * float(np.abs(w).max())).mean())
        assert share <= BEYOND, (variant, name, share)


def _local_shape(shape, spec):
    """The shard of ``shape`` a rank holds under ``spec`` on the (2, 4) mesh."""
    out = []
    for d, axes in zip(shape, spec):
        axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
        out.append(d // int(np.prod([MESH[a] for a in axes])))
    return tuple(out)


@pytest.mark.parametrize("variant", list(GSPMD_VARIANTS))
def test_every_local_shard_has_its_specs_shape(results, variant):
    """Each rank's shard of every parameter and first moment is the shape its
    spec gives on the (2, 4) mesh; the moments are sharded over "model", and
    over "data" too under fsdp or ZeRO-1."""
    _, port = results
    key, kw = GSPMD_VARIANTS[variant]
    specs = lm.param_specs(gspmd_config(key))
    mesh = SimpleNamespace(axis_names=tuple(MESH), shape=MESH)  # all the rules read
    plan = ShardingPlan(**kw)
    p_spec = param_spec_tree(specs, plan, mesh)
    m_spec = opt_state_sharding({"m": specs}, plan, mesh)["m"]
    for res in port:
        got = res[variant]
        assert got["local"] == {n: _local_shape(s, p_spec[n]) for n, (s, _) in specs.items()}
        assert got["local_m"] == {n: _local_shape(s, m_spec[n]) for n, (s, _) in specs.items()}
    sharded = {a for spec in m_spec.values() for axes in spec if axes
               for a in ((axes,) if isinstance(axes, str) else axes)}
    assert sharded == ({"data", "model"} if plan.fsdp or plan.zero1 else {"model"})
    if plan.zero1:  # the moments sharded where the parameters are not
        assert any(m_spec[n] != p_spec[n] for n in specs)


@pytest.mark.parametrize("variant", list(GSPMD_VARIANTS))
def test_every_rank_reports_the_same_metrics(results, variant):
    _, port = results
    for res in port[1:]:
        assert res[variant]["losses"] == port[0][variant]["losses"]
        assert res[variant]["grad_norms"] == port[0][variant]["grad_norms"]


def test_the_moe_routes_the_global_batch(results):
    """Routing each data rank's rows alone (the capacity and the drops of half
    the batch) moves the MoE's losses off JAX's; the gathered batch does not."""
    ref, port = results
    want = np.asarray(ref["moe"][0])
    local = np.asarray(port[0]["moe_local"]["losses"])
    assert np.max(np.abs(local - want) / np.abs(want)) > 100 * LOSS_RTOL
    np.testing.assert_allclose(port[0]["moe"]["losses"], want, rtol=LOSS_RTOL)


def test_ranks_sit_at_their_mesh_positions(results):
    """Row major on the (2, 4) mesh; on the reordered (4, 2) one, rank r's
    pair sits at data position (r // 2) * 3 % 4 (ring_order(4, 3))."""
    _, port = results
    for rank, res in enumerate(port):
        assert (res["pos"]["data"], res["pos"]["model"]) == divmod(rank, 4)
        assert res["reordered"]["data_pos"] == [0, 3, 2, 1][rank // 2]


@pytest.fixture
def one_rank():
    """Leaves no process group behind (jit_train_step joins one of one rank)."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", list(GSPMD_CONFIGS))
def test_world_size_one_equals_make_train_step_to_the_bit(one_rank, arch):
    """(``arch``: a GSPMD_CONFIGS key.)  On a one-rank (1, 1) mesh under
    fsdp, every gather, reduce-scatter and mean is over one rank: two steps
    give make_train_step's metrics and parameters bit for bit.  The step installs its activation policy for its
    own duration only: none is left behind."""
    cfg = gspmd_config(arch)
    spec = DataSpec(cfg=cfg, shape=ShapeSpec("t", GSPMD_SEQ, 4, "train"), seed=0)
    batches = [{k: torch.from_numpy(v) for k, v in batch_for_step(spec, s).items()}
               for s in range(2)]
    opt = adamw(wsd(GSPMD_LR, 10))
    model = lm.init(0, cfg, device="cpu")
    state = opt.init(dict(model.named_parameters()))
    plain = make_train_step(cfg, opt)
    want = [plain(model, state, b, s)[2] for s, b in enumerate(batches)]

    step, (_, _, p_layouts, o_layouts, _) = jit_train_step(
        cfg, opt, ShardingPlan(fsdp=True), Mesh(np.zeros((1, 1), dtype=np.int64),
                                                 ("data", "model")), device="cpu")
    placed = lm.init(0, cfg, device="cpu", place=placer(p_layouts))
    placed_state = init_opt_state(opt, placed, o_layouts)
    got = [step(placed, placed_state, b, s)[2] for s, b in enumerate(batches)]
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    assert all(torch.equal(g[k], w[k]) for g, w in zip(got, want) for k in w)
    params = parameters(placed)
    assert all(torch.equal(params[n].full_tensor(), p) for n, p in model.named_parameters())
    assert act_sharding.get_policy() is None


@pytest.mark.parametrize("arch", ["granite-8b", "falcon-mamba-7b", "recurrentgemma-9b",
                                  "llama-3.2-vision-11b", "hubert-xlarge", "qwen3-moe-30b-a3b"])
def test_the_mean_of_equal_row_shards_losses_is_the_global_loss(arch):
    """What the step's split relies on: each family's loss is a mean over
    rows that mask the same number of tokens (the last token of each
    sequence; none for the audio encoder's labels), so the mean of two
    halves' losses is the whole batch's.  The MoE's is not (its aux loss,
    capacity and drops are the global batch's): its layer gathers the rows."""
    cfg = (gspmd_config(arch) if arch == "qwen3-moe-30b-a3b" else
           dataclasses.replace(tbase_config(arch).smoke(), param_dtype="float32",
                               activation_dtype="float32"))
    spec = DataSpec(cfg=cfg, shape=ShapeSpec("t", GSPMD_SEQ, 4, "train"), seed=0)
    batch = {k: torch.from_numpy(v) for k, v in batch_for_step(spec, 0).items()}
    model = lm.init(0, cfg, device="cpu")
    with torch.no_grad():
        whole = lm.loss_fn(model, batch, cfg)[0]
        halves = [lm.loss_fn(model, {k: v[i:i + 2] for k, v in batch.items()}, cfg)[0]
                  for i in (0, 2)]
    mean = (halves[0] + halves[1]) / 2
    if cfg.family == "moe":
        assert abs(float(mean - whole)) > 1e-4 * abs(float(whole))
    else:
        torch.testing.assert_close(mean, whole, rtol=1e-6, atol=0)
