"""The port's DLRM slice against the JAX package: the plain ``ref_embedding_bag``
against JAX's oracle and its Pallas kernel (interpret mode) on the shapes and
bars of test_kernels.py, the lookup's id semantics, and ``models.dlrm``'s
forward and loss against ``repro.models.dlrm`` on the same parameters."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import workloads
from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag as pallas_embedding_bag
from repro.models import dlrm as jdlrm
from repro_torch.configs.base import get_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.ref import ref_embedding_bag
from repro_torch.launch import trace_serve
from repro_torch.models import dlrm, layers, lm
from repro_torch.weights import dlrm_params_from_jax

torch.set_num_threads(2)  # several test processes share the cores

# test_kernels.py:109, (T, R, E, B, NNZ).
BAG_SHAPES = [(3, 50, 16, 2, 4), (1, 10, 8, 4, 1), (5, 100, 32, 3, 7)]
# tests/test_dlrm_model.py:11.
CFG = jdlrm.DLRMConfig(n_tables=4, rows_per_table=100, embed_dim=16,
                       dense_features=13, bottom_mlp=(32, 16), top_mlp=(32, 1))
TCFG = dlrm.DLRMConfig(**dataclasses.asdict(CFG))
# test_models_smoke.py's fp32 bar for the models.
FP32 = dict(rtol=2e-4, atol=2e-4)


def _bag_inputs(seed, T, R, E, B, NNZ, id_dtype=np.int32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, R, E)).astype(np.float32),
            rng.integers(0, R, (B, T, NNZ)).astype(id_dtype))


def _bag_tol(tables, NNZ):
    """test_kernels.py's bar: the sums run in another order, so NNZ ulps of
    the largest term on top of rtol 1e-6."""
    return dict(rtol=1e-6, atol=NNZ * np.finfo(np.float32).eps * float(np.abs(tables).max()))


@pytest.mark.parametrize("target", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("T,R,E,B,NNZ", BAG_SHAPES)
def test_ref_embedding_bag_matches_jax(target, T, R, E, B, NNZ):
    tables, ids = _bag_inputs(0, T, R, E, B, NNZ)
    if target == "jax_ref":
        expect = jref.ref_embedding_bag(jnp.asarray(tables), jnp.asarray(ids))
    else:
        expect = pallas_embedding_bag(jnp.asarray(tables), jnp.asarray(ids), interpret=True)
    out = ref_embedding_bag(torch.from_numpy(tables), torch.from_numpy(ids))
    assert out.dtype == torch.float32 and out.shape == (B, T, E)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **_bag_tol(tables, NNZ))


@pytest.mark.parametrize("T,R,E,B,NNZ", BAG_SHAPES)
def test_ref_embedding_bag_takes_bf16_tables_and_int64_ids(T, R, E, B, NNZ):
    """bf16 tables are summed in fp32 and rounded once; int64 ids (numpy's
    default) give the int32 ids' sums."""
    tables, ids = _bag_inputs(1, T, R, E, B, NNZ, id_dtype=np.int64)
    t16 = torch.from_numpy(tables).bfloat16()
    out = ref_embedding_bag(t16, torch.from_numpy(ids))
    assert out.dtype == torch.bfloat16
    expect = jref.ref_embedding_bag(jnp.asarray(t16.float().numpy()),
                                    jnp.asarray(ids.astype(np.int32)))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expect), rtol=2e-2, atol=2e-2)
    t32 = torch.from_numpy(tables)
    assert torch.equal(ref_embedding_bag(t32, torch.from_numpy(ids)),
                       ref_embedding_bag(t32, torch.from_numpy(ids.astype(np.int32))))


def test_ref_embedding_bag_clamps_and_wraps_ids_as_the_reference_gathers():
    """ids R, R + 7, -1, -R and -R - 3 against the reference's XLA gather,
    which clamps an id past the table and wraps a negative one."""
    T, R, E = 2, 6, 4
    tables, _ = _bag_inputs(2, T, R, E, 1, 1)
    raw = np.array([R, R + 7, -1, -R, -R - 3, 2], np.int32)
    ids = np.repeat(raw[:, None, None], T, axis=1)  # (6, T, 1)
    expect = jref.ref_embedding_bag(jnp.asarray(tables), jnp.asarray(ids))
    out = ref_embedding_bag(torch.from_numpy(tables), torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(expect))
    rows = [R - 1, R - 1, R - 1, 0, 0, 2]
    np.testing.assert_array_equal(out.numpy(), tables[:, rows].transpose(1, 0, 2))


def test_ops_bag_lookup_on_cpu_takes_the_plain_path_and_counts_no_launch(monkeypatch):
    monkeypatch.setattr(ops, "bag_lookup_launches", 0)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    tables, ids = (torch.from_numpy(a) for a in _bag_inputs(3, 3, 20, 8, 4, 5))
    assert torch.equal(ops.bag_lookup(tables, ids), ref_embedding_bag(tables, ids))
    assert ops.bag_lookup_launches == 0


@pytest.mark.parametrize("devices", [("cpu", "cpu"), ("cpu", "meta"), ("meta", "cpu")])
def test_kernel_wrapper_refuses_cpu_and_mixed_devices(devices, monkeypatch):
    """The CUDA wrapper never computes off the card, and raises before any build."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    tables = torch.zeros(2, 10, 8, device=devices[0])
    ids = torch.zeros(3, 2, 1, dtype=torch.int32, device=devices[1])
    with pytest.raises(ValueError, match="one CUDA device"):
        embedding_bag(tables, ids)


def _jax_params(seed=0):
    return jdlrm.init(jax.random.PRNGKey(seed), CFG)


def _np_params(jparams):
    return jax.tree.map(np.asarray, jparams)


def _port_model(jparams):
    model = dlrm.init(0, TCFG, device="cpu")
    model.load_state_dict(dlrm_params_from_jax(_np_params(jparams), TCFG))
    return model


def _batch(seed, B=64, lo=0, hi=CFG.rows_per_table):
    rng = np.random.default_rng(seed)
    sparse = rng.integers(lo, hi, (B, CFG.n_tables)).astype(np.int32)
    return {"dense": rng.standard_normal((B, CFG.dense_features)).astype(np.float32),
            "sparse": sparse, "label": (sparse[:, 0] % 2).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_and_loss_match_reference_fp32(seed):
    jparams = _jax_params(seed)
    model = _port_model(jparams)
    batch = _batch(seed + 10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _torch_batch(batch)
    expect = jdlrm.forward(jparams, jb["dense"], jb["sparse"], CFG)
    out = dlrm.forward(model, tb["dense"], tb["sparse"], TCFG)
    assert out.shape == (64,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **FP32)
    (jloss, jaux) = jdlrm.loss_fn(jparams, jb, CFG)
    loss, aux = dlrm.loss_fn(model, tb, TCFG)
    np.testing.assert_allclose(float(loss), float(jloss), **FP32)
    np.testing.assert_allclose(float(aux["bce"]), float(jaux["bce"]), **FP32)


def test_lookup_with_one_id_equals_the_reference_gather():
    """The port's lookup (``ops.bag_lookup`` with NNZ = 1) is the reference
    model's gather, exactly."""
    jparams = _jax_params()
    sparse = _batch(3, B=8)["sparse"]
    expect = jnp.einsum(
        "tbe->bte", jparams["tables"][jnp.arange(CFG.n_tables)[:, None], jnp.asarray(sparse).T]
    )
    tables = torch.tensor(np.asarray(jparams["tables"]))
    out = ops.bag_lookup(tables, torch.from_numpy(sparse)[:, :, None])
    np.testing.assert_array_equal(out.numpy(), np.asarray(expect))


def test_forward_with_ids_past_the_table_matches_reference():
    """ids R and -1 (and beyond) score as the reference's clamped and wrapped
    gather does."""
    jparams = _jax_params()
    model = _port_model(jparams)
    R = CFG.rows_per_table
    batch = _batch(4, B=16, lo=-R - 5, hi=2 * R)
    batch["sparse"][:4] = [[R, -1, R + 3, -R]] * 4
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    expect = jdlrm.forward(jparams, jb["dense"], jb["sparse"], CFG)
    out = dlrm.forward(model, torch.from_numpy(batch["dense"]),
                       torch.from_numpy(batch["sparse"]), TCFG)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **FP32)


def test_paper_config_is_the_papers_dlrm():
    cfg = dlrm.paper_config()
    assert cfg.n_tables == 8 and dlrm.paper_config(64).n_tables == workloads.DLRM.n_tables
    assert cfg.rows_per_table == workloads.DLRM.table_rows
    assert cfg.embed_dim == workloads.DLRM.table_dim
    assert cfg.dense_features == 13
    assert cfg.bottom_mlp == (2048,) * 8 and cfg.top_mlp == (4096,) * 16 + (1,)
    # workloads.DLRM's dense parameters: 8 dense layers of 2048, 16 feature layers of 4096.
    assert 8 * 2048**2 + 16 * 4096**2 == workloads.DLRM.dense_params
    assert dataclasses.asdict(dlrm.DLRMConfig()) == dataclasses.asdict(jdlrm.DLRMConfig())


def test_init_draws_each_table_in_place(monkeypatch):
    """Each table is drawn into its slice of the one (T, R, E) tensor, never
    into a table of its own that is then stacked (twice the memory)."""
    filled = []
    real = layers.truncated_normal_

    def recording(t, gen, scale):
        filled.append((t.data_ptr(), tuple(t.shape)))
        return real(t, gen, scale)

    monkeypatch.setattr(layers, "truncated_normal_", recording)
    model = dlrm.init(0, TCFG, device="cpu")
    tables = model.tables
    R, E = TCFG.rows_per_table, TCFG.embed_dim
    want = [(tables[t].data_ptr(), (R, E)) for t in range(TCFG.n_tables)]
    assert filled[:TCFG.n_tables] == want
    assert tables.dtype == torch.float32 and tables.shape == (TCFG.n_tables, R, E)
    assert float(tables.abs().max()) <= 2.0 / np.sqrt(E) + 1e-6
    assert len({float(tables[t].std()) for t in range(TCFG.n_tables)}) == TCFG.n_tables


def test_init_layouts_and_seeds():
    model = dlrm.init(0, TCFG, device="cpu")
    sd = model.state_dict()
    jshapes = jax.tree.map(lambda a: a.shape, _jax_params())
    assert sd["tables"].shape == jshapes["tables"]
    for name in ("bottom", "top"):
        assert len(model.get_submodule(name)) == len(jshapes[name])
        for i, lyr in enumerate(jshapes[name]):
            assert sd[f"{name}.{i}.w"].shape == lyr["w"] and sd[f"{name}.{i}.b"].shape == lyr["b"]
            assert not sd[f"{name}.{i}.b"].any()
    assert all(t.dtype == torch.float32 for t in sd.values())
    assert torch.equal(dlrm.init(0, TCFG, device="cpu").tables, model.tables)
    assert not torch.equal(dlrm.init(1, TCFG, device="cpu").tables, model.tables)


def test_dlrm_params_from_jax_checks_depths():
    np_params = _np_params(_jax_params())
    sd = dlrm_params_from_jax(np_params, TCFG)
    assert sorted(sd) == sorted(dlrm.init(0, TCFG, device="cpu").state_dict())
    with pytest.raises(ValueError, match="bottom"):
        dlrm_params_from_jax(np_params, dataclasses.replace(TCFG, bottom_mlp=(32,)))
    with pytest.raises(ValueError, match="top"):
        dlrm_params_from_jax(np_params, dataclasses.replace(TCFG, top_mlp=(32, 32, 1)))


def test_lm_facade_points_recsys_to_the_dlrm_module():
    with pytest.raises(NotImplementedError, match="repro_torch.models.dlrm"):
        lm.init(0, get_config("dlrm-paper"), device="cpu")


def test_init_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dlrm.init(0, TCFG)


def test_trace_serve_dlrm_needs_a_card_and_one_model(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_serve.main(["--dlrm", "8", "--batch", "4096"])
    for argv in ([], ["--dlrm", "8", "--arch", "granite-8b"]):
        with pytest.raises(SystemExit):
            trace_serve.main(argv)
