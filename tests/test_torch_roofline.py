"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's: parameter counts, model FLOPs and the terms' record, and the
closed-form count of the pairs each attention mask keeps."""

import pytest
import torch

from repro.configs.base import ALL_SHAPES as REF_SHAPES
from repro.configs.base import all_configs as ref_all_configs
from repro.configs.base import shape_applicability as ref_applicability
from repro.launch import mesh as ref_mesh
from repro.launch import roofline as ref
from repro_torch.configs.base import ALL_SHAPES, all_configs
from repro_torch.kernels.ref import attention_mask
from repro_torch.launch import roofline

torch.set_num_threads(2)  # several test processes share the cores

LM_NAMES = sorted(n for n, c in all_configs().items() if c.family != "recsys")


def test_every_lm_config_is_the_references():
    assert LM_NAMES == sorted(n for n, c in ref_all_configs().items() if c.family != "recsys")


@pytest.mark.parametrize("name", LM_NAMES)
def test_param_counts_equal_the_references(name):
    assert roofline.param_counts(all_configs()[name]) == ref.param_counts(ref_all_configs()[name])


@pytest.mark.parametrize("name", LM_NAMES)
def test_model_flops_equal_the_references_at_every_applicable_shape(name):
    cfg, ref_cfg = all_configs()[name], ref_all_configs()[name]
    shapes = [(s, r) for s, r in zip(ALL_SHAPES, REF_SHAPES) if ref_applicability(ref_cfg, r)[0]]
    assert shapes
    for shape, ref_shape in shapes:
        assert shape.name == ref_shape.name
        assert roofline.model_flops(cfg, shape) == pytest.approx(
            ref.model_flops(ref_cfg, ref_shape), rel=1e-12)


@pytest.mark.parametrize("name,links", [("qwen3-moe-30b-a3b", 4), ("falcon-mamba-7b", 18)])
def test_terms_record_equals_the_references_on_its_constants(monkeypatch, name, links):
    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16", ref_mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(roofline, "HBM_BW", ref_mesh.HBM_BW)
    monkeypatch.setattr(roofline, "NVLINK_LINK_BW", ref_mesh.ICI_LINK_BW)
    analysis = {"flops": 3.1e15, "bytes": 7.7e12, "collective_bytes": 2.5e10}
    shape, ref_shape = ALL_SHAPES[0], REF_SHAPES[0]
    got = roofline.roofline(analysis, 2.5e10, 256, all_configs()[name], shape, links).as_dict()
    want = ref.roofline(analysis, 2.5e10, 256, ref_all_configs()[name], ref_shape,
                        links).as_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == (v if isinstance(v, str) else pytest.approx(v, rel=1e-12)), k


def test_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == {torch.bfloat16: 989e12, torch.float16: 989e12,
                                   torch.float32: 67e12}
    assert (roofline.HBM_BW, roofline.NVLINK_LINK_BW, roofline.NVLINK_LINKS_PER_CHIP) == (
        3.35e12, 25e9, 18)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_pairs_count_the_mask(causal):
    for sq in (1, 2, 5, 16, 33):
        for sk in (1, 3, 16, 31, 64):
            for window in (0, 1, 2, 7, 16, 40, 100):
                want = int(attention_mask(sq, sk, causal, window).sum())
                assert roofline.attention_pairs(sq, sk, causal, window) == want, (
                    sq, sk, window)


def test_attention_pairs_at_the_production_shapes():
    assert roofline.attention_pairs(4096, 4096, True, 0) == 4096 * 4097 // 2
    assert roofline.attention_pairs(32768, 32768, False, 0) == 32768 ** 2
    # recurrentgemma's 2048-token window over a 32k prompt: rows past the
    # window keep 2048 keys, the first 2047 rows keep q + 1.
    assert roofline.attention_pairs(32768, 32768, True, 2048) == (
        2047 * 2048 // 2 + (32768 - 2047) * 2048)


def test_kernel_costs():
    assert roofline.attention_flops(2, 8, 64, 16, 16, True, 0) == 4.0 * 2 * 8 * 64 * 136
    assert roofline.attention_flops(2, 8, 64, 16, 16, True, 0, backward=True) == (
        10.0 * 2 * 8 * 64 * 136)
    assert roofline.grouped_matmul_flops(4, 5, 6, 7) == 2.0 * 4 * 5 * 6 * 7
    assert roofline.grouped_matmul_flops(4, 5, 6, 7, products=2) == 4.0 * 4 * 5 * 6 * 7
