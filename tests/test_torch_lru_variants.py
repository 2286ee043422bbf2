"""The variants that ``tools/lru_variants.py`` builds of the RG-LRU scan's
kernels are text edits of ``csrc/rglru_scan.cu`` and ``csrc/rglru_scan_bwd.cu``:
each must still find the lines it replaces in both, so that an edit of the
kernels cannot silently leave the tool measuring something else.  The builds
and timings themselves need the card."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("lru_variants", ROOT / "tools" / "lru_variants.py")
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)
CSRC = ROOT / "src" / "repro_torch" / "csrc"


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_variant_edits_apply_to_both_kernels(name):
    got = variants.texts(name)
    for source, entry in ((variants.FWD, "repro_rglru_scan("),
                          (variants.BWD, "repro_rglru_scan_bwd(")):
        text = (CSRC / source).read_text()
        if name == "default":
            assert got[source] == text
        else:
            assert got[source] != text, source
            assert entry in got[source]


def test_a_missing_line_is_refused():
    with pytest.raises(SystemExit, match="no line"):
        variants.kv.edited((variants.FWD,), [("no such line", "")], "lru_variants")
