"""The variants that ``tools/gmm_bwd_variants.py`` builds of the grouped-
matmul backward's wgmma kernel are text edits of ``csrc/moe_gmm_bwd.cu`` and
``csrc/hopper.cuh``: each must still find the lines it replaces, so that an
edit of the kernel cannot silently leave the tool measuring something else.
The builds and timings themselves need the card."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("gmm_bwd_variants",
                                               ROOT / "tools" / "gmm_bwd_variants.py")
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_variant_edits_apply(name):
    header = (variants.CSRC / "hopper.cuh").read_text()
    source = (variants.CSRC / "moe_gmm_bwd.cu").read_text()
    got = variants.edited(name)
    if name == "default":
        assert got == (header, source)
    else:
        assert got != (header, source)
        assert "gmm_bwd_wgmma_kernel" in got[1] and "repro_moe_gmm_bwd_wgmma" in got[1]


def test_every_run_names_a_variant():
    assert {name for _, name, _ in variants.RUNS} <= set(variants.VARIANTS)
    assert {name for _, name, _ in variants.RUNS} >= set(variants.VARIANTS) - {"default"}
