"""The variants that ``tools/scan_bwd_variants.py`` builds of the Mamba scan's
backward kernel are text edits of ``csrc/mamba_scan_bwd.cu``: each must still
find the lines it replaces, so that an edit of the kernel cannot silently
leave the tool measuring something else.  The builds and timings themselves
need the card."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("scan_bwd_variants",
                                               ROOT / "tools" / "scan_bwd_variants.py")
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_variant_edits_apply(name):
    source = (ROOT / "src" / "repro_torch" / "csrc" / "mamba_scan_bwd.cu").read_text()
    got = variants.edited(name)
    if name == "default":
        assert got == source
    else:
        assert got != source
        assert "mamba_bwd_kernel" in got and "repro_mamba_scan_bwd" in got


def test_a_missing_line_is_refused():
    with pytest.raises(SystemExit, match="no line"):
        variants.kv.edited((variants.SOURCE,), [("no such line", "")], "scan_bwd_variants")
