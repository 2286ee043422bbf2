"""The port's GSPMD trainer computes over ``"model"`` as the reference's
GSPMD program does: each model rank on its own share, on the CPU.

On 8 gloo ranks on the (2, 4) ("data", "model") mesh (``_torch_ranks``'s
``tp_compute`` job, one launch for the module), one ``jit_train_step`` of
each family's smoke config (4 query heads, 256 tokens; the MoE's 4 experts,
the MLPs' 128 columns, Mamba's 128 and RG-LRU's 64 channels), under fsdp
and under sequence parallelism, records what each rank's plain kernels and
matmuls receive and which parameters it gathers over ``"model"``: one query
head, one expert, DI/4 channels, F/4 hidden columns and V/4 logits columns
a rank, and no weight gathered whole over ``"model"`` but K/V with fewer
heads than ranks, Mamba's ``w_in`` (its x and z halves are each split) and
the weights of layers whose units do not divide 4 (2 heads, 250 tokens,
130 MLP columns, 6 experts, 66 RG-LRU channels: computed whole).  Every
case's gradients, averaged over the data ranks, are held to the plain
model's on the global batch.  The model axis's collectives are held to
single-process sums.
"""

import numpy as np
import pytest
from _torch_ranks import TP_CASES, TP_PLANS, launch, tp_collective_inputs, tp_config

TP = 4  # the mesh's model ranks
GRAD_TOL = 1e-4  # of each gradient's largest entry: the order of additions differs
# Parameters read whole though "model" splits them: (case, leaf names).
WHOLE_OVER_MODEL = {
    "dense": {"attn.wk", "attn.wv"},  # 1 KV head for 4 ranks
    "tied": set(),
    "moe": {"attn.wk", "attn.wv"},
    "ssm": {"w_in"},
    "hybrid": {"attn.wk", "attn.wv"},
    "vlm": {"attn.wk", "attn.wv"},
    "audio": set(),  # 4 KV heads
    "indivisible": {"attn.wq", "attn.wk", "attn.wv", "attn.wo"},  # 2 heads
    "experts6": {"attn.wk", "attn.wv"},  # (E, D, F) is not split over 4 at E = 6
    "lru66": {"attn.wk", "attn.wv"},  # nor are 66 channels
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch("tp_compute", 8, tmp_path_factory.mktemp("tp_compute"))


CASES = [(c, p) for c in TP_CASES for p in TP_PLANS]


def _leaf(name: str) -> str:
    """``blocks.3.attn.wk`` -> ``attn.wk``; ``layers.0.rec.w_x`` -> ``rec.w_x``."""
    parts = name.split(".")
    return ".".join(parts[2:] if parts[0] in ("blocks", "layers") else parts)


@pytest.mark.parametrize("case,plan", CASES)
def test_the_gradients_are_the_plain_models(ranks, case, plan):
    for res in ranks:
        errs = res["cases"][(case, plan)]["grad_errs"]
        bad = {n: e for n, e in errs.items() if not e <= GRAD_TOL}
        assert not bad, bad


@pytest.mark.parametrize("case,plan", CASES)
def test_attention_runs_on_the_ranks_own_heads(ranks, case, plan):
    cfg = tp_config(case)
    split = cfg.n_heads % TP == 0
    heads = cfg.n_heads // TP if split else cfg.n_heads
    kv = (cfg.n_kv_heads // TP if cfg.n_kv_heads % TP == 0 else 1) if split else cfg.n_kv_heads
    for res in ranks:
        shapes = res["cases"][(case, plan)]["attention"]
        assert bool(shapes) == (cfg.family != "ssm")
        for q, k in shapes:
            assert (q[1], k[1]) == (heads, kv)
            # the whole sequence, also under seq-parallel; a cross layer's
            # keys are the image's
            assert q[2] == 32 and k[2] in (32, cfg.img_tokens)


@pytest.mark.parametrize("case,plan", CASES)
def test_grouped_matmul_runs_on_the_ranks_own_experts(ranks, case, plan):
    cfg = tp_config(case)
    for res in ranks:
        shapes = res["cases"][(case, plan)]["grouped_matmul"]
        assert bool(shapes) == (cfg.family == "moe")
        want = cfg.n_experts // TP if cfg.n_experts % TP == 0 else cfg.n_experts
        assert all(x[0] == want for x in shapes)


@pytest.mark.parametrize("case,plan", CASES)
def test_scans_run_on_the_ranks_own_channels(ranks, case, plan):
    cfg = tp_config(case)
    name = {"ssm": "selective_scan", "hybrid": "lru_scan"}.get(cfg.family)
    di = cfg.d_inner // TP if cfg.d_inner % TP == 0 else cfg.d_inner
    for res in ranks:
        got = res["cases"][(case, plan)]
        for scan in ("selective_scan", "lru_scan"):
            assert bool(got[scan]) == (scan == name)
            assert all(s == (4, 32, di) for s in got[scan])


@pytest.mark.parametrize("case,plan", CASES)
def test_mlp_runs_on_the_ranks_own_columns(ranks, case, plan):
    cfg = tp_config(case)
    for res in ranks:
        products = res["cases"][(case, plan)]["matmul"]
        D, F = cfg.d_model, cfg.d_ff
        if cfg.family in ("ssm", "moe"):
            assert (D, F) not in products and (F, D) not in products
        elif F % TP == 0:
            assert (D, F // TP) in products and (F // TP, D) in products
            assert (D, F) not in products and (F, D) not in products
        else:
            assert (D, F) in products and (F, D) in products


@pytest.mark.parametrize("case,plan", CASES)
def test_the_head_makes_the_ranks_own_logits_columns(ranks, case, plan):
    cfg = tp_config(case)
    want = cfg.vocab // TP if cfg.vocab % TP == 0 else cfg.vocab
    for res in ranks:
        got = res["cases"][(case, plan)]
        assert got["logits"] and all(s[-1] == want for s in got["logits"])
        assert (cfg.d_model, cfg.vocab) not in got["matmul"] or want == cfg.vocab
        # the whole sequence under a split head; this rank's share of it
        # under seq-parallel with a head read whole
        seq = 32 // TP if plan == "seq" and want == cfg.vocab else 32
        assert all(s[:2] == (4, seq) for s in got["logits"])


@pytest.mark.parametrize("case,plan", CASES)
def test_only_the_listed_weights_are_gathered_whole_over_model(ranks, case, plan):
    for res in ranks:
        got = {_leaf(n) for n in res["cases"][(case, plan)]["whole_over_model"]}
        assert got == WHOLE_OVER_MODEL[case]


def _by_index(ranks):
    """The collectives' results of the first data row, by model index."""
    out = {}
    for res in ranks[:TP]:
        c = res["collectives"]
        out[c["index"]] = c
    assert sorted(out) == list(range(TP))
    return out


@pytest.mark.parametrize("name", ["enter", "reduce", "gather_seq", "scatter_seq", "whole", "btd"])
def test_model_axis_collectives_match_single_process_sums(ranks, name):
    """Each model rank's forward and its input's gradient, given every
    rank's input and upstream gradient: enter (identity; the gradients
    summed), reduce (the inputs summed; its own gradient), gather_seq (the
    inputs concatenated along the sequence; its share of the gradients'
    sum), scatter_seq (its share of the inputs' sum; the gradients
    concatenated), constrain's 'whole' under sequence parallelism (the
    inputs concatenated; its share of its own gradient) and 'btd' of a
    whole input (its share; the gradients concatenated).  The second data
    row of the mesh gives the same."""
    got = _by_index(ranks)
    inp = [tp_collective_inputs(i) for i in range(TP)]
    s = 12 // TP
    share = lambda t, i: t[:, i * s:(i + 1) * s]  # noqa: E731
    for i in range(TP):
        if name == "enter":
            y, g = inp[i]["x"], sum(p["g_share"] for p in inp)
        elif name == "reduce":
            y, g = sum(p["x"] for p in inp), inp[i]["g_share"]
        elif name == "gather_seq":
            y = np.concatenate([p["x"] for p in inp], axis=1)
            g = share(sum(p["g_whole"] for p in inp), i)
        elif name == "scatter_seq":
            y = share(sum(p["x_seq"] for p in inp), i)
            g = np.concatenate([p["g_share"] for p in inp], axis=1)
        elif name == "whole":
            y = np.concatenate([p["x"] for p in inp], axis=1)
            g = share(inp[i]["g_common"], i)
        else:
            y = share(inp[i]["x_seq"], i)
            g = np.concatenate([p["g_share"] for p in inp], axis=1)
        gy, gg = got[i][name]
        np.testing.assert_allclose(gy, y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gg, g, rtol=1e-6, atol=1e-6)
    for res in ranks[TP:]:
        c = res["collectives"]
        for mine, first in zip(c[name], got[c["index"]][name]):
            np.testing.assert_array_equal(mine, first)
