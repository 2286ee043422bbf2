"""The port's serving under a mesh (``train.steps.jit_serve_step``) against
the JAX package's sharded serve step, on the CPU.

The JAX side runs in subprocesses with 8 forced host devices on a (2, 4)
("data", "model") mesh, as ``repro.launch.dryrun`` lowers a serve cell:
prefill jitted with the parameters' and the batch's shardings (through
``lm.prefill(..., pad_to)`` where a cache is padded, as ``repro.launch.serve``
pads it), decode with ``out_shardings=(None, <the cache's>)``.  The port's
runs on 8 gloo ranks (``_torch_ranks``'s ``serve_mesh`` job) on the port's
mesh of the same shape, from the same weights (``weights.params_from_jax``,
fp32) and prompts (global batch 4): granite-8b's smoke config (one KV head
over 4 model ranks) under fsdp, without it and under sequence parallelism;
qwen3-moe-30b-a3b's at capacity 1.0 (its experts over ``"model"``, its
decode capacity the global batch's); falcon-mamba-7b's and
recurrentgemma-9b's at prompts of 12 and 20 (Griffin's 16-slot ring has
wrapped at 20), Griffin's also under sequence parallelism;
llama-3.2-vision-11b's (8 image tokens, 2 a model rank; cross gates at 0.5
on both sides); hubert-xlarge's (prefill only); a 12-token prompt in a
32-slot cache (at the first decode step ranks 2 and 3 hold no valid
position) and in a 30-slot one (indivisible: every rank holds it whole);
minicpm-2b's under sequence parallelism (4 KV heads, one a rank, moved by an
all-to-all; its tied head split by vocabulary).  GSPMD computes the
single-device function; the port computes each rank's rows, heads,
experts, channels and positions, so the two differ in the order of
additions only: prefill's and 4 decode steps' logits, and every cache leaf
gathered, are held at ``tests/test_torch_model.py``'s fp32 bar, the greedy
ids exactly.  At world size 1 the step equals ``make_serve_step`` to the
bit, for all six LM families.  On a job of its own (``serve_one_row``), one
prompt, which the 2 data ranks cannot split, is held to the single-device
step on every rank.
"""

import dataclasses
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _subproc import run_with_devices
from _torch_ranks import (
    GSPMD_CONFIGS, GSPMD_GATE, SERVE_BATCH, SERVE_CASES, SERVE_DECODE, gspmd_config, launch,
    serve_inputs,
)

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.device_order import Mesh
from repro_torch.models import lm
from repro_torch.parallel import act_sharding
from repro_torch.parallel.sharding import ShardingPlan, placer
from repro_torch.train.steps import jit_serve_step, make_serve_step

torch.set_num_threads(2)  # several test processes share the cores

RTOL = ATOL = 2e-4  # tests/test_torch_model.py's fp32 bar
JAX_RUNS = 2  # JAX subprocesses beside the port's ranks
# Cases whose decode writes past the cache's last slot: Griffin's 12-slot
# cache after a 12-token prompt, below its 16-token window.  The reference's
# single-device function clamps the write to the last slot
# (lax.dynamic_update_slice); XLA's partitioned program, the cache's slots
# split over "model", drops it.  The port keeps the single-device rule, so
# these cases are held to the reference's single-device function as well.
CLAMPED = ("hybrid_12",)

_JAX = """
import dataclasses, pickle
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import ShapeSpec, get_config
from repro.models import lm
from repro.parallel.act_sharding import set_policy
from repro.parallel.sharding import ShardingPlan, batch_sharding, param_sharding
from repro.train.steps import install_activation_policy, make_serve_step

with open({inputs!r}, "rb") as f:
    inp = pickle.load(f)
# jax.make_mesh's explicit axes would reject the reference's gathers.
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
B = {batch!r}


def serve(name, sharded):
    key, kw, S, pad_to = inp["cases"][name]
    arch, over = inp["configs"][key]
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    plan = ShardingPlan(**kw)
    params = jax.tree.map(jnp.asarray, inp["params"][key])
    batch = {{k: jnp.asarray(v) for k, v in inp["batches"][name].items()}}
    if sharded:
        install_activation_policy(plan, mesh)  # as dryrun_cell does
        p_sh = param_sharding(lm.param_specs(cfg), plan, mesh)
        params = jax.device_put(params, p_sh)
        jit = lambda f, b_sh, **kw: jax.jit(f, in_shardings=(p_sh, b_sh), **kw)
    else:  # the single-device function
        set_policy(None)
        jit = lambda f, b_sh, **kw: jax.jit(f)
    if pad_to:  # as repro.launch.serve pads the cache
        prefill = jit(lambda p, b: lm.prefill(p, b, cfg, pad_to=pad_to),
                      batch_sharding(batch, cfg, plan, mesh))
    else:
        prefill = jit(make_serve_step(cfg, ShapeSpec("p", S, B, "prefill")),
                      batch_sharding(batch, cfg, plan, mesh))
    with mesh:
        logits, cache = prefill(params, batch)
    rec = {{"logits": [np.asarray(logits)], "cache0": jax.tree.map(np.asarray, cache)}}
    if cfg.is_encoder:
        return rec
    T = cache["k"].shape[3] if "k" in cache else S
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    d_sh = batch_sharding({{"token": tok, "pos": jnp.int32(S), "cache": cache}}, cfg, plan, mesh)
    decode = jit(make_serve_step(cfg, ShapeSpec("d", T, B, "decode")), d_sh,
                 out_shardings=(None, d_sh["cache"]))
    ids = [tok]
    for i in range({steps!r}):
        dbatch = {{"token": tok, "pos": jnp.int32(S + i), "cache": cache}}
        if sharded:  # in the decode cell's layouts (the prefill left its own)
            dbatch = jax.device_put(dbatch, d_sh)
        with mesh:
            logits, cache = decode(params, dbatch)
        rec["logits"].append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        ids.append(tok)
    rec["ids"] = np.stack([np.asarray(t) for t in ids], axis=1)
    rec["cache"] = jax.tree.map(np.asarray, cache)
    return rec


out = {{}}
for name in {cases!r}:
    out[name] = serve(name, sharded=True)
    if name in {clamped!r}:
        out[name]["single"] = serve(name, sharded=False)
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("PASS")
"""


def _jcfg(key):
    arch, over = GSPMD_CONFIGS[key]
    return dataclasses.replace(jget_config(arch).smoke(), **over)


def _jparams(key):
    """The JAX package's weights of config ``key`` from seed 0 as numpy, a
    VLM's cross gates set to GSPMD_GATE."""
    cfg = _jcfg(key)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jlm.init(k, cfg))(jax.random.PRNGKey(0)))
    if cfg.family == "vlm":
        attn = params["blocks"]["cross"]["attn"]
        attn["gate"] = np.full_like(attn["gate"], GSPMD_GATE)
    return params


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's results by case, the port's by rank).  JAX_RUNS subprocesses, a
    share of the cases each, run beside the port's 8 ranks."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    keys = sorted({key for key, *_ in SERVE_CASES.values()})
    inputs = {"params": {k: _jparams(k) for k in keys}, "configs": GSPMD_CONFIGS,
              "cases": SERVE_CASES,
              "batches": {n: serve_inputs(n, gspmd_config(c[0])) for n, c in SERVE_CASES.items()}}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    names = list(SERVE_CASES)
    shares = [names[i::JAX_RUNS] for i in range(JAX_RUNS)]
    codes = [_JAX.format(inputs=str(tmp / "inputs.pkl"), cases=c, batch=SERVE_BATCH,
                         steps=SERVE_DECODE, clamped=CLAMPED, path=str(tmp / f"jax{i}.pkl"))
             for i, c in enumerate(shares)]
    with ThreadPoolExecutor(JAX_RUNS) as pool:
        runs = [pool.submit(run_with_devices, code, 8) for code in codes]
        port = launch("serve_mesh", 8, tmp / "port", dict(inputs, cases=names))
        assert all("PASS" in r.result() for r in runs)
    ref = {}
    for i in range(JAX_RUNS):
        with open(tmp / f"jax{i}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    return ref, port


def _decodes(case) -> bool:
    return not gspmd_config(SERVE_CASES[case][0]).is_encoder


def _want(ref, case) -> dict:
    """What the port is held to: the JAX sharded step's results, or for a
    CLAMPED case the single-device function's."""
    return ref[case]["single"] if case in CLAMPED else ref[case]


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_logits_match_jax(results, case):
    """Prefill's logits ((B, V); the audio encoder's (B, S, V)) and each
    decode step's, the global batch's on every rank."""
    ref, port = results
    want = _want(ref, case)["logits"]
    assert len(want) == (1 + SERVE_DECODE if _decodes(case) else 1)
    assert all(np.isfinite(w).all() for w in want)
    for res in port:
        got = res[case]["logits"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", [c for c in SERVE_CASES if _decodes(c)])
def test_greedy_ids_match_jax(results, case):
    ref, port = results
    for res in port:
        np.testing.assert_array_equal(res[case]["ids"], _want(ref, case)["ids"])


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_every_cache_leaf_matches_jax(results, case):
    """After the prefill and after the last decode step, each leaf gathered
    whole (no NaN where a rank's share of the positions was all masked)."""
    ref, port = results
    stages = ("cache0", "cache") if _decodes(case) else ("cache0",)
    for stage in stages:
        want = _want(ref, case)[stage]
        for res in port:
            got = res[case][stage]
            assert sorted(got) == sorted(want)
            for name, w in want.items():
                np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{stage} {name}")


@pytest.mark.parametrize("case", CLAMPED)
def test_the_sharded_reference_drops_a_clamped_write(results, case):
    """Why CLAMPED cases are held to the single-device function: there the
    first decode step writes its key over the last prompt key (slot T - 1),
    the JAX sharded step leaves that slot as the prefill left it, and the
    port writes it as the single-device function does.  Their prefills
    agree."""
    ref, port = results
    sharded, single = ref[case], ref[case]["single"]
    np.testing.assert_allclose(sharded["logits"][0], single["logits"][0], rtol=RTOL, atol=ATOL)
    last = (Ellipsis, -1, slice(None))
    for name in ("k", "v"):
        np.testing.assert_allclose(sharded["cache0"][name], single["cache0"][name], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(sharded["cache"][name][last], sharded["cache0"][name][last])
        assert np.abs(single["cache"][name][last] - single["cache0"][name][last]).max() > 1e-2
        for res in port:
            np.testing.assert_allclose(res[case]["cache"][name][last], single["cache"][name][last],
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_each_cache_shard_has_its_layouts_shape(results, case):
    """B/2 rows; T/4 positions of every KV head (the whole T where 4 does not
    divide it); DI/4 channels of ``ssm``, ``conv`` and ``lru``."""
    ref, port = results
    key, _, S, pad_to = SERVE_CASES[case]
    cfg = gspmd_config(key)
    specs = lm.prefill_cache_specs(cfg, SERVE_BATCH, S, pad_to)
    for res in port:
        got = res[case]["local"]
        assert sorted(got) == sorted(specs)
        for name, (shape, _) in specs.items():
            assert tuple(ref[case]["cache0"][name].shape) == shape
            B, *rest = shape[1:]
            want = list(shape)
            want[1] = B // 2
            if name in ("k", "v", "xk", "xv"):
                want[3] = shape[3] // 4 if shape[3] % 4 == 0 else shape[3]
                assert want[2] == cfg.n_kv_heads  # every KV head
            else:
                di = {"ssm": 2, "conv": 3, "lru": 2}[name]
                assert shape[di] == cfg.d_inner and want[di] % 4 == 0
                want[di] = shape[di] // 4
            assert got[name] == tuple(want), (name, got[name], want)


def test_the_masked_and_whole_caches_split_as_intended(results):
    """32 slots: 8 a rank, of which ranks 2 and 3 hold none of the 12 prompt
    positions; 30 slots: whole on every rank."""
    _, port = results
    for res in port:
        assert res["masked"]["local"]["k"][3] == 8
        assert res["whole"]["local"]["k"][3] == 30
    assert all(res["pos"] == {"data": r // 4, "model": r % 4} for r, res in enumerate(port))


@pytest.fixture
def one_rank():
    """Leaves no process group behind (jit_serve_step joins one of one rank)."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("key", ["granite-8b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
                                 "recurrentgemma-9b", "llama-3.2-vision-11b", "hubert-xlarge"])
def test_world_size_one_equals_make_serve_step_to_the_bit(one_rank, key):
    """On a one-rank (1, 1) mesh under fsdp and sequence parallelism, prefill
    (padded, as serving pads it) and 4 greedy decode steps give
    make_serve_step's logits and caches bit for bit; the step installs its
    activation policy for its own duration only."""
    cfg = gspmd_config(key)
    S, T = 12, 12 + SERVE_DECODE
    batch = {k: torch.from_numpy(v) for k, v in serve_inputs("fsdp", cfg).items()}
    if cfg.family == "audio":
        batch = {"frames": batch["frames"][:, :S]}
    model = lm.init(0, cfg, device="cpu")
    mesh = Mesh(np.zeros((1, 1), dtype=np.int64), ("data", "model"))
    plan = ShardingPlan(fsdp=True, seq_parallel=True)
    prefill, (_, p_layouts, batch_fn) = jit_serve_step(
        cfg, ShapeSpec("p", S, SERVE_BATCH, "prefill"), plan, mesh, device="cpu", pad_to=T)
    placed = lm.init(0, cfg, device="cpu", place=placer(p_layouts))
    want, want_cache = lm.prefill(model, batch, cfg, pad_to=T)
    got, cache = prefill(placed, batch)
    assert torch.equal(got, want)
    assert sorted(cache) == sorted(want_cache)
    assert all(torch.equal(cache[n].full_tensor(), w) for n, w in want_cache.items())
    if not cfg.is_encoder:
        shape = ShapeSpec("d", want_cache["k"].shape[3] if "k" in want_cache else S,
                          SERVE_BATCH, "decode")
        plain = make_serve_step(cfg, shape)
        decode, _ = jit_serve_step(cfg, shape, plan, mesh, device="cpu")
        layouts = batch_fn(shape)["cache"]
        assert {n: t.placements for n, t in cache.items()} == {
            n: layouts[n].placements for n in cache}
        tok = want.argmax(-1)
        for i in range(SERVE_DECODE):
            want, want_cache = plain(model, {"token": tok, "pos": S + i, "cache": want_cache})
            got, cache = decode(placed, {"token": tok, "pos": S + i, "cache": cache})
            assert torch.equal(got, want)
            assert all(torch.equal(cache[n].full_tensor(), w) for n, w in want_cache.items())
            tok = want.argmax(-1)
    assert act_sharding.get_policy() is None


ONE_ROW = ("granite-8b", "falcon-mamba-7b", "recurrentgemma-9b")


def test_one_row_is_left_whole_on_every_data_rank(tmp_path):
    """A batch of one prompt (``long_500k``'s), which the 2 data ranks
    cannot split: every data rank computes the row, nothing is gathered over
    them, and prefill's and each decode step's logits are the single-device
    step's at the fp32 bar, on every rank."""
    tokens = np.random.default_rng(11).integers(0, 256, (1, 12)).astype(np.int32)
    port = launch("serve_one_row", 8, tmp_path, {"cases": ONE_ROW, "tokens": tokens})
    for key in ONE_ROW:
        cfg = gspmd_config(key)
        model = lm.init(0, cfg, device="cpu")
        prefill = make_serve_step(cfg, ShapeSpec("p", 12, 1, "prefill"))
        decode = make_serve_step(cfg, ShapeSpec("d", 16, 1, "decode"))
        with torch.no_grad():
            if cfg.family in ("ssm", "hybrid"):
                logits, cache = prefill(model, {"tokens": torch.from_numpy(tokens)})
            else:
                logits, cache = lm.prefill(model, {"tokens": torch.from_numpy(tokens)}, cfg,
                                           pad_to=16)
            want = [logits.numpy()]
            for i in range(SERVE_DECODE):
                logits, cache = decode(model, {"token": logits.argmax(-1), "pos": 12 + i,
                                               "cache": cache})
                want.append(logits.numpy())
        for rank in port:
            for got, w in zip(rank[key], want, strict=True):
                np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL)
